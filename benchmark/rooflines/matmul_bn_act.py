"""Operations and bytes of one ``matmul_bn_act`` launch
(ops/matmul_bn_act.py -> csrc/matmul_bn_act.cu), as chip_smoke.py counts
them: a 1x1 convolution of stride s as an (R, K) x (K, N) product over
the R = B * Ho * Wo rows it reads, with the BN bias (fp32), an optional
residual of the output's shape, and ReLU."""

MODULE = "clipbert_tpu_torch.ops.matmul_bn_act"
FUNCTION = "_launch"
TRACE_MATCH = "matmul_bn_act"


def shape(args, kwargs):
    x, w_nk, _scale, _bias, residual, _relu, bhw, stride = args[:8]
    B, H, W = bhw
    N, K = w_nk.shape
    return (B, H, W, K, N, stride, residual is not None, x.element_size())


def work(shape):
    """(operations, bytes)."""
    B, H, W, K, N, stride, res, item = shape
    R = B * ((H - 1) // stride + 1) * ((W - 1) // stride + 1)
    nbytes = (R * K + K * N + R * N * (2 if res else 1)) * item + N * 4
    return 2.0 * R * K * N, float(nbytes)
