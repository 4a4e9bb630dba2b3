"""The share (%) of the VQA validation calls' time in which their loop
waited on the loader threads: the program's ``vqa.data_wait`` spans over
its ``vqa.validate`` spans (``clipbert_tpu_torch/utils/profiling.py::
totals``, the spans of the traced window)."""


def read(run):
    try:
        from clipbert_tpu_torch.utils.profiling import totals
    except ImportError:     # a program without the span facility
        return None
    t = totals()
    part = t.get("vqa.data_wait", {}).get("s", 0.0)
    whole = t.get("vqa.validate", {}).get("s", 0.0)
    if part <= 0 or whole <= 0:
        return None
    return 100.0 * part / whole
