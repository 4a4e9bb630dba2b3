"""Operations and bytes of one ``fused_stem_pool`` launch
(ops/fused_stem_pool.py -> csrc/fused_stem_pool.cu), as chip_smoke.py
counts them: the 7x7 / 2 stem convolution (3 -> 64 channels, pad 3) with
its BN bias and ReLU, then the 3x3 / 2 max pool, reading the frames once
and writing the pooled map once; fp32 weights and bias."""

MODULE = "clipbert_tpu_torch.ops.fused_stem_pool"
FUNCTION = "_launch"
TRACE_MATCH = "fused_stem_pool"


def shape(args, kwargs):
    x = args[0]
    B, H, W, _ = x.shape
    return (B, H, W, x.element_size())


def work(shape):
    """(operations, bytes)."""
    B, H, W, item = shape
    Hc, Wc = (H + 1) // 2, (W + 1) // 2
    Hp, Wp = (Hc + 1) // 2, (Wc + 1) // 2
    nbytes = (B * H * W * 3 + B * Hp * Wp * 64) * item + 64 * 147 * 4 + 64 * 4
    return 2.0 * B * Hc * Wc * 64 * 147, float(nbytes)
