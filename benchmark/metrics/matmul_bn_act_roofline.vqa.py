"""matmul_bn_act's launches in the traced VQA eval window, as a share (%)
of their roofline bound (benchmark/rooflines/matmul_bn_act.py) over
their device time."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "matmul_bn_act")
