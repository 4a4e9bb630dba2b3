"""The share (%) of the Kimi-VL retrieval eval's ``inference_retrieval``
calls spent before a call's first video group, on the host alone (caption
encoding and its copies, the steps' set-up): the ``retrieval.setup``
spans over the ``retrieval.call`` spans
(``clipbert_tpu_torch/utils/profiling.py::totals``, the traced
window)."""


def read(run):
    try:
        from clipbert_tpu_torch.utils.profiling import totals
    except ImportError:     # a program without the span facility
        return None
    t = totals()
    part = t.get("retrieval.setup", {}).get("s", 0.0)
    whole = t.get("retrieval.call", {}).get("s", 0.0)
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
