"""The routed-expert layer of DeepSeek-V3 (Kimi-VL's language model;
models/deepseek_v3.py): the router, the rows permuted into expert order,
the expert products, and the combine with the shared experts.

HF ``DeepseekV3MoE`` with ``topk_method="noaux_tc"``, ``scoring_func=
"sigmoid"`` and one expert group:

    scores  = sigmoid(x W_gate^T)                      (fp32)
    chosen  = top_k(scores + e_score_correction_bias)  (the bias only picks)
    weights = scores[chosen] / sum(scores[chosen]) * routed_scaling_factor
    y       = sum_j weights_j * down_e(silu(gate_e(x)) * up_e(x)) + shared(x)

It replaces no kernel of the JAX package, which has no experts.

Two paths compute the experts:

- grouped (a bf16 CUDA input outside autograd: every eval forward): one
  device-side sort gives each (token, slot) pair its row in an
  expert-sorted buffer in which each expert's run of rows is padded to a
  multiple of 128 (``ROW_TILE``, the wg GEMM's row tile), and each row
  tile's expert; two launches of the grouped wg GEMM (``
  csrc/matmul_bn_act.cu`` moe_grouped_gemm_wg_kernel) then compute every
  expert's gate|up product (D -> 2 I) and, after SiLU x up, its down
  product (I -> D). The host knows only the buffer's bound, T k + E 127
  rows rounded up to 128; the kernel reads the live tile count and each
  tile's expert from device memory, so nothing waits for the device.
  Padding rows are zero in and scratch out, and no combine reads them.
- plain (the CPU, fp32, autograd): a Python loop over the experts with
  ops/linear.py::dense_reference.

Both combine alike: the shared experts' output plus each token's k expert
rows weighted in fp32, in slot order, rounded once to x's dtype. The
expert weights are stacked, (E, 2 I, D) gate|up and (E, D, I) down
(models/deepseek_v3.py::Experts holds the mapping to the published
per-expert names).

Counters: ``MOE_GROUPED_CALLS`` and ``MOE_PLAIN_CALLS`` count the CUDA
calls of :func:`moe_experts` that took each path (CPU calls count
nothing); ``GROUPED_LAUNCHES`` the grouped kernel's launches. While a
``utils/profiling.py::collect()`` scope is open the layer adds its rows per
expert to a device tensor (:func:`expert_load`), read once after the
window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from clipbert_tpu_torch.ops import matmul_bn_act as mba
from clipbert_tpu_torch.ops import refuse_autograd
from clipbert_tpu_torch.ops.linear import dense_reference
from clipbert_tpu_torch.utils import profiling

MOE_GROUPED_CALLS = 0
MOE_PLAIN_CALLS = 0
GROUPED_LAUNCHES = 0
ROW_TILE = mba._WG_BM

_EXPERT_LOAD: Optional[torch.Tensor] = None


def expert_load() -> Optional[torch.Tensor]:
    """Rows routed to each expert, summed over every layer and call made
    while a ``collect()`` scope was open (int64 (E,), on the device), or
    None where none was."""
    return _EXPERT_LOAD


def reset_expert_load() -> None:
    global _EXPERT_LOAD
    _EXPERT_LOAD = None


def _tally(counts: torch.Tensor) -> None:
    """Add a call's rows per expert to :func:`expert_load` while a
    ``collect()`` scope is open (a device add: nothing waits)."""
    global _EXPERT_LOAD
    if profiling.collecting():
        _EXPERT_LOAD = counts if _EXPERT_LOAD is None \
            else _EXPERT_LOAD + counts


def route(x: torch.Tensor, gate_weight: torch.Tensor,
          correction_bias: torch.Tensor, top_k: int, scaling: float,
          norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) -> the k chosen experts (T, k) int64 and their weights
    (T, k) fp32: the fp32 sigmoid scores of the router, the top k of the
    scores plus ``correction_bias`` (ties go to the lower expert index, in
    descending order), the weights from the scores without the bias,
    renormalised over the k and scaled by ``scaling``."""
    with profiling.span("moe.route"):
        logits = x.float() @ gate_weight.float().t()
        scores = torch.sigmoid(logits)
        choice = scores + correction_bias.float()
        idx = torch.topk(choice, top_k, dim=-1, sorted=True).indices
        w = scores.gather(1, idx)
        if top_k > 1 and norm_topk:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * scaling


class RowPlan(NamedTuple):
    """Where each (token, slot) pair's row lies in the expert-sorted,
    tile-padded buffer. ``dest`` (T, k) int64; ``src`` (rows,) int64, the
    token each buffer row copies (T, a zero row, for padding); ``
    tile_expert`` (rows / ROW_TILE,) int32; ``live_m`` (1,) int32, the row
    tiles that hold rows; ``counts`` (E,) int64; ``rows``, the buffer's
    host-known length."""
    dest: torch.Tensor
    src: torch.Tensor
    tile_expert: torch.Tensor
    live_m: torch.Tensor
    counts: torch.Tensor
    rows: int


def padded_rows(pairs: int, n_experts: int) -> int:
    """The buffer's bound: every expert's run padded to ROW_TILE rows
    adds at most ROW_TILE - 1 rows an expert."""
    bound = pairs + n_experts * (ROW_TILE - 1)
    return -(-bound // ROW_TILE) * ROW_TILE


def plan_rows(idx: torch.Tensor, n_experts: int) -> RowPlan:
    """The expert-sorted layout of ``idx``'s (T, k) choices, on idx's
    device with no host sync: pair p = t k + j goes to row pad_start[e] +
    (its rank among expert e's pairs, in pair order), where pad_start is
    the exclusive running sum of each expert's count rounded up to
    ROW_TILE."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    n = flat.numel()
    dev = idx.device
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + ROW_TILE - 1) // ROW_TILE * ROW_TILE
    pad_end = torch.cumsum(padded, 0)
    start = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    dest = (pad_end - padded)[flat] + rank - start[flat]
    rows = padded_rows(n, n_experts)
    src = torch.full((rows,), T, dtype=torch.int64, device=dev)
    src[dest] = torch.arange(n, device=dev) // k
    tiles = torch.arange(rows // ROW_TILE, device=dev) * ROW_TILE
    tile_expert = torch.searchsorted(pad_end, tiles, right=True).clamp_(
        max=n_experts - 1).to(torch.int32)
    live_m = (pad_end[-1:] // ROW_TILE).to(torch.int32)
    return RowPlan(dest.reshape(T, k), src, tile_expert, live_m, counts,
                   rows)


def grouped_plan(rows: int, K: int, N: int, n_sms: int) -> mba.Plan:
    """The grouped launch (csrc clipbert_moe_grouped_gemm): the wg body's
    tile width, stages and shared memory at (rows, K, N), one persistent
    block per SM at most over the bound's rows / ROW_TILE x N / BN
    tiles."""
    tile_n = mba._wg_tile_n(rows, K, N, n_sms)
    tiles = rows // ROW_TILE * -(-N // tile_n)
    return mba.Plan("wg", min(tiles, n_sms), mba._WG_THREADS,
                    mba._wg_smem_bytes(tile_n), tile_n,
                    mba._wg_stages(tile_n))


# clipbert_moe_grouped_gemm's parameters (csrc/matmul_bn_act.cu): x, w,
# tile_expert, live_m, out; R, K, N, E; the plan's tile_n, the SM count,
# grid, shared bytes, stages; the stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5
             + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("matmul_bn_act").clipbert_moe_grouped_gemm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _grouped_launch(x: torch.Tensor, w: torch.Tensor,
                    tile_expert: torch.Tensor, live_m: torch.Tensor,
                    pairs: int) -> torch.Tensor:
    """One launch of the grouped kernel on bf16 CUDA operands: x (rows,
    K) contiguous, rows a multiple of ROW_TILE; w (E, N, K); tile_expert
    (rows / ROW_TILE,) and live_m (1,) int32 on x's device."""
    global GROUPED_LAUNCHES
    refuse_autograd("moe_grouped_gemm", x, w)
    R, K = x.shape
    E, N, Kw = w.shape
    if (Kw != K or R % ROW_TILE or x.dtype != torch.bfloat16
            or w.dtype != torch.bfloat16
            or tuple(tile_expert.shape) != (R // ROW_TILE,)
            or tile_expert.dtype != torch.int32
            or live_m.dtype != torch.int32 or live_m.numel() != 1):
        raise ValueError(f"grouped GEMM operands: x {tuple(x.shape)} "
                         f"{x.dtype}, w {tuple(w.shape)} {w.dtype}, "
                         f"tile_expert {tuple(tile_expert.shape)}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    n_sms = mba._n_sms(x.device.index if x.device.index is not None
                       else torch.cuda.current_device())
    plan = grouped_plan(R, K, N, n_sms)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
                       live_m.data_ptr(), out.data_ptr(), R, K, N, E,
                       plan.tile_n, n_sms, plan.grid, plan.smem_bytes,
                       plan.stages, stream)
    if rc == mba._PLAN_MISMATCH:
        raise RuntimeError(f"moe_grouped_gemm: the kernel derives another "
                           f"launch than {plan}")
    if rc == mba._TENSOR_MAP_FAILED:
        raise RuntimeError(f"moe_grouped_gemm: the driver refused a tensor "
                           f"map for {plan}")
    if rc != 0:
        raise RuntimeError(f"moe_grouped_gemm kernel launch failed: CUDA "
                           f"error {rc}")
    GROUPED_LAUNCHES += 1
    return out


def swiglu(h: torch.Tensor, width: int) -> torch.Tensor:
    """silu(h[:, :width]) * h[:, width:] in h's dtype, as HF computes
    ``act_fn(gate_proj(x)) * up_proj(x)`` in bf16."""
    return F.silu(h[..., :width]) * h[..., width:]


def _experts_grouped(x: torch.Tensor, idx: torch.Tensor,
                     gate_up: torch.Tensor, down: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k expert rows of every token through the grouped products:
    (the buffer (rows, D), the pair -> row map (T, k))."""
    T, k = idx.shape
    E, two_i = gate_up.shape[:2]
    with profiling.span("moe.permute"):
        plan = plan_rows(idx, E)
        _tally(plan.counts)
        x_ext = torch.cat([x, x.new_zeros(1, x.shape[1])])
        x_rows = x_ext.index_select(0, plan.src)
    with profiling.span("moe.experts"):
        h = _grouped_launch(x_rows, gate_up, plan.tile_expert,
                            plan.live_m, T * k)
        del x_rows
        a = swiglu(h, two_i // 2)
        del h
        y = _grouped_launch(a, down, plan.tile_expert, plan.live_m, T * k)
    return y, plan.dest


def _experts_plain(x: torch.Tensor, idx: torch.Tensor,
                   gate_up: torch.Tensor, down: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same rows by a loop over the experts: (the (T k, D) rows in
    pair order, the pair -> row map)."""
    T, k = idx.shape
    flat = idx.reshape(-1)
    if profiling.collecting():
        _tally(torch.zeros(gate_up.shape[0], dtype=torch.int64,
                           device=x.device).scatter_add_(
                               0, flat, torch.ones_like(flat)))
    y = x.new_zeros(T * k, down.shape[1])
    with profiling.span("moe.experts"):
        for e in range(gate_up.shape[0]):
            pairs = (flat == e).nonzero()[:, 0]
            if pairs.numel() == 0:
                continue
            h = dense_reference(x[pairs // k], gate_up[e])
            y[pairs] = dense_reference(swiglu(h, gate_up.shape[1] // 2),
                                       down[e])
    return y, torch.arange(T * k, device=x.device).reshape(T, k)


def combine(y: torch.Tensor, dest: torch.Tensor, weights: torch.Tensor,
            shared: torch.Tensor) -> torch.Tensor:
    """The shared experts' output plus sum_j weights[t, j] * y[dest[t, j]]
    in fp32, slot by slot, rounded once to shared's dtype. Each slot's
    rows are gathered in y's dtype and widened inside the fused
    multiply-add, so no fp32 copy of them is written."""
    with profiling.span("moe.combine"):
        acc = shared.float()
        for j in range(dest.shape[1]):
            acc.addcmul_(y.index_select(0, dest[:, j]), weights[:, j:j + 1])
        return acc.to(shared.dtype)


def moe_experts(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                gate_up: torch.Tensor, down: torch.Tensor,
                shared: torch.Tensor) -> torch.Tensor:
    """The routed experts on (T, D) tokens for ``idx``/``weights`` (from
    :func:`route`), combined with the shared experts' output ``shared``
    (T, D); returns (T, D) in x's dtype."""
    global MOE_GROUPED_CALLS, MOE_PLAIN_CALLS
    tracked = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, gate_up, down))
    if x.is_cuda and x.dtype == torch.bfloat16 and not tracked:
        MOE_GROUPED_CALLS += 1
        y, dest = _experts_grouped(x, idx, gate_up.to(x.dtype),
                                   down.to(x.dtype))
    else:
        if x.is_cuda:
            MOE_PLAIN_CALLS += 1
        y, dest = _experts_plain(x, idx, gate_up, down)
    return combine(y, dest, weights, shared)
