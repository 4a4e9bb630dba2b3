"""Operations and bytes of one latent-attention core
(models/deepseek_v3.py::attention_core -> ops/fused_attention.py ->
csrc/fused_attention.cu, the tc body at q/k head dim 192 and v head dim
128, causal): softmax(QK^T * scale + bias) V over (B, S, H), q and k
counted at their width, v and the output at theirs. Only the S (S + 1) / 2
kept (query, key) pairs are counted, as the kernel skips the key tiles
past each query tile. Each operand is read once and the output written
once; the fp32 key bias is (B, S). Recorded at attention_core, which only
the deepseek_v3 encoder calls, one fused launch a call on the card."""

MODULE = "clipbert_tpu_torch.models.deepseek_v3"
FUNCTION = "attention_core"
TRACE_MATCH = "fused_attention"


def shape(args, kwargs):
    q, _k, v = args[:3]
    B, S, H, dk = q.shape
    return (B, S, H, dk, v.shape[-1], True, q.element_size())


def work(shape):
    """(operations, bytes)."""
    B, S, H, dk, dv, causal, item = shape
    pairs = S * (S + 1) / 2 if causal else S * S
    ops = 2.0 * B * H * pairs * (dk + dv)
    nbytes = B * S * H * (2 * dk + 2 * dv) * item + B * S * 4
    return ops, float(nbytes)
