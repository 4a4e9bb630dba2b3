"""The grouped expert GEMM's launches in the traced Kimi-VL retrieval eval
window, as a share (%) of their roofline bound
(benchmark/rooflines/moe_grouped_gemm.py) over their device time."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "moe_grouped_gemm")
