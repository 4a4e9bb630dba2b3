"""The share (%) of the loader threads' time that went to building
batches: the ``loader.batch`` spans (one a batch's items and collate, on
its worker thread) over the ``vqa.validate`` spans times the traffic's
``loader_workers`` (``clipbert_tpu_torch/utils/profiling.py::totals``, the
traced window)."""


def read(run):
    try:
        from clipbert_tpu_torch.utils.profiling import totals
    except ImportError:     # a program without the span facility
        return None
    t = totals()
    part = t.get("loader.batch", {}).get("s", 0.0)
    whole = t.get("vqa.validate", {}).get("s", 0.0) \
        * run["traffic"]["loader_workers"]
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
