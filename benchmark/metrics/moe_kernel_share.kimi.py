"""The share (%) of ``ops/moe.py::moe_experts``'s CUDA calls that ran the
grouped expert GEMM rather than the plain loop over experts, over the
Kimi-VL retrieval eval's process (set-up and window):
``MOE_GROUPED_CALLS`` over it plus ``MOE_PLAIN_CALLS``."""


def read(run):
    try:
        from clipbert_tpu_torch.ops import moe
    except ImportError:
        return None
    grouped = getattr(moe, "MOE_GROUPED_CALLS", None)
    plain = getattr(moe, "MOE_PLAIN_CALLS", None)
    if grouped is None or plain is None or grouped + plain == 0:
        return None
    return 100.0 * grouped / (grouped + plain)
