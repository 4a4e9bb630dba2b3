"""fused_stem_pool's launches in the traced Kimi-VL retrieval eval window,
as a share (%) of their roofline bound
(benchmark/rooflines/fused_stem_pool.py) over their device time."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "fused_stem_pool")
