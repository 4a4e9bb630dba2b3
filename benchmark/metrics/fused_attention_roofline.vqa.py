"""fused_attention's launches in the traced VQA eval window, as a share (%)
of their roofline bound (benchmark/rooflines/fused_attention.py) over
their device time."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "fused_attention")
