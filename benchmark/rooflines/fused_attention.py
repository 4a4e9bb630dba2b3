"""Operations and bytes of one ``fused_attention`` launch
(ops/fused_attention.py -> csrc/fused_attention.cu), as chip_smoke.py
counts them: softmax(QK^T / sqrt(dh) + bias) V over (B, S, H, dh).
Each operand is read once and the output written once; the fp32 key
bias is (B, S)."""

MODULE = "clipbert_tpu_torch.ops.fused_attention"
FUNCTION = "_launch"
TRACE_MATCH = "fused_attention"


def shape(args, kwargs):
    q = args[0]
    return tuple(q.shape) + (q.element_size(),)


def work(shape):
    """(operations, bytes)."""
    B, S, H, dh, item = shape
    return 4.0 * B * H * S * S * dh, 4.0 * B * S * H * dh * item + B * S * 4
