"""The share (%) of the VQA validation calls' time spent in
``tasks/common.py::device_batch``'s pageable host-to-device copies, which
block the host: the ``device_batch.copy`` spans over the ``vqa.validate``
spans (``clipbert_tpu_torch/utils/profiling.py::totals``, the traced
window)."""


def read(run):
    try:
        from clipbert_tpu_torch.utils.profiling import totals
    except ImportError:     # a program without the span facility
        return None
    t = totals()
    part = t.get("device_batch.copy", {}).get("s", 0.0)
    whole = t.get("vqa.validate", {}).get("s", 0.0)
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
