"""matmul_bn_act's launches in the traced Kimi-VL retrieval eval window
(the CNN's 1x1 convs and ``ops/linear.py::dense``'s products: MLA's four,
the shared experts', layer 0's SwiGLU and the head's), as a share (%) of
their roofline bound (benchmark/rooflines/matmul_bn_act.py) over their
device time. The grouped expert GEMM has a kernel name of its own and is
not counted here."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "matmul_bn_act")
