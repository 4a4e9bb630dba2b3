"""The share (%) of ``ops/linear.py::dense``'s CUDA calls that launched
matmul_bn_act's kernel (the bias-free products of the deepseek_v3 joint
encoder and the head's, one rounding in its epilogue) rather than the
unfused formula, over the Kimi-VL retrieval eval's process (set-up and
window): ``DENSE_KERNEL_CALLS`` over it plus ``DENSE_PLAIN_CALLS``."""


def read(run):
    try:
        from clipbert_tpu_torch.ops import linear
    except ImportError:
        return None
    kernel = getattr(linear, "DENSE_KERNEL_CALLS", None)
    plain = getattr(linear, "DENSE_PLAIN_CALLS", None)
    # None for a program without the counters, or with no CUDA call
    if kernel is None or plain is None or kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
