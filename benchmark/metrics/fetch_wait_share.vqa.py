"""The share (%) of the VQA validation calls' time in which the host
waited for the device's logits (``tasks/common.py::HostFetch.numpy``): the
``host_fetch.wait`` spans over the ``vqa.validate`` spans
(``clipbert_tpu_torch/utils/profiling.py::totals``, the traced window)."""


def read(run):
    try:
        from clipbert_tpu_torch.utils.profiling import totals
    except ImportError:     # a program without the span facility
        return None
    t = totals()
    part = t.get("host_fetch.wait", {}).get("s", 0.0)
    whole = t.get("vqa.validate", {}).get("s", 0.0)
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
