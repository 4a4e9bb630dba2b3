"""Operations and bytes of one grouped expert GEMM launch
(ops/moe.py::_grouped_launch -> csrc/matmul_bn_act.cu,
moe_grouped_gemm_wg_kernel): the (token, expert) rows, T x top_k of them
(host-known), each times its expert's (N, K) weight. Each row is read
once and written once; every expert's weight is read once. The padding
rows of each expert's last tile are not counted."""

MODULE = "clipbert_tpu_torch.ops.moe"
FUNCTION = "_grouped_launch"
TRACE_MATCH = "moe_grouped_gemm"


def shape(args, kwargs):
    x, w, _tile_expert, _live_m, pairs = args[:5]
    E, N, K = w.shape
    return (int(pairs), K, N, E, x.element_size())


def work(shape):
    """(operations, bytes)."""
    rows, K, N, E, item = shape
    return 2.0 * rows * K * N, float((rows * (K + N) + E * N * K) * item)
