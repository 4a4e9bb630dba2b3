"""Fused multi-head attention core: the CUDA kernel's wrapper, its plain
PyTorch version and its launch counters.

Port of clipbert_tpu/ops/pallas_attention.py::fused_attention:
``softmax(q k^T * scale + key_bias[b, key]) v`` with an exact full-row fp32
softmax, probabilities cast to v's dtype before PV, result in q's dtype.
The kernel (``csrc/fused_attention.cu``) keeps the scores on chip; the
unfused form materializes a (B, H, S, S) fp32 score tensor in device
memory.

The source has two hand-written bodies, and :func:`_plan` chooses one by
dtype and shape: ``"tc"`` (both products on the tensor cores, the exact
softmax in registers) for bf16 with dh a multiple of 16 and S <=
``TC_MAX_SEQ`` = 176, which is every joint length of the repo's configs
(69 for retrieval, 149-174 for the QA family and pretraining); ``"v2"``
(the fp32 CUDA-core body) for fp32, longer sequences and other head
widths. ``TC_LAUNCHES`` counts the tensor-core body's launches.

The tc body runs one warp per 16 query rows and keeps a row's 16 * tiles
fp32 scores in registers (88 at S = 161-176): 128-168 registers a thread
past S = 128. So a (batch item, head)'s query tiles split over blocks of
at most ``TC_BLOCK_WARPS`` warps (:func:`_tc_split`; two blocks past S =
96), each with all its K and V as bf16 and its key bias in fp32 in shared
memory, 64 * tiles * (dh + 9) bytes (51,392 at S = 176, dh = 64): two or
three blocks share an SM where one block of 11 warps would sit alone.

Latent attention (models/deepseek_v3.py, DeepSeek-V3's MLA) passes q and
k 192 wide (``MLA_QK_DIM``: 128 + 64 RoPE dims), v 128 wide
(``MLA_V_DIM``) and ``causal=True``: the tc body at those widths, each
warp skipping the key tiles past its own query tile. The tc body takes
dk == dv up to 128 (not causal) or that one pair; the v2 body dk == dv,
not causal.

Routing: a CPU tensor takes :func:`fused_attention_reference`; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from clipbert_tpu_torch.ops import refuse_autograd

# Kernel launches on the card since the process started (or since a caller
# reset it). Incremented only where the CUDA kernel is launched; TC_LAUNCHES
# counts those of the tensor-core body and SHARD_HEADS_LAUNCHES those made
# through fused_attention_shard_heads (both in LAUNCHES too). Under a CUDA
# graph's capture nothing runs: utils/cuda_graphs.py takes a capture's
# counts back and adds them again at each replay of the graph.
LAUNCHES = 0
TC_LAUNCHES = 0
SHARD_HEADS_LAUNCHES = 0

MAX_SEQ = 640
MAX_HEAD_DIM = 128
TC_MAX_SEQ = 176        # csrc/fused_attention.cu kTcMaxSeq: S in registers
TC_BLOCK_WARPS = 6      # csrc/fused_attention.cu kTcBlockWarps
MLA_QK_DIM = 192        # csrc/fused_attention.cu kMlaQkDim, kMlaVDim
MLA_V_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODES = {"v2": 0, "tc": 1}
_PLAN_MISMATCH = -1     # csrc/fused_attention.cu kPlanMismatch
# the v2 body's fixed shape (csrc/fused_attention.cu kWarps, kScoreBytes,
# kSmemBytes) and its rows-per-warp instantiations
_V2_WARPS = 8
_V2_SCORE_BYTES = 96 * 1024
_V2_SMEM_BYTES = 200 * 1024
_V2_ROWS = (1, 2, 4, 9, 16)


class Plan(NamedTuple):
    """One launch: the body, its grid (blocks), warps per block, dynamic
    shared-memory bytes per block, and whether q/k/v are staged 16 bytes at
    a time (cp.async in the tensor-core body) or element by element."""
    body: str
    grid: int
    warps: int
    smem_bytes: int
    vec: bool


def _tc_dims_ok(dh: int, dv: int, causal: bool) -> bool:
    """The tc body's head widths (csrc tc_dims_ok)."""
    if (dh, dv) == (MLA_QK_DIM, MLA_V_DIM):
        return True
    return dh == dv and dh % 16 == 0 and dh <= MAX_HEAD_DIM and not causal


def _plan(B: int, S: int, H: int, dh: int, dtype: torch.dtype,
          aligned: bool, body: Optional[str] = None,
          dv: Optional[int] = None, causal: bool = False) -> Plan:
    """The launch the C entry point makes for these operands (it derives
    the same plan and refuses a different one). ``dh`` is q's and k's head
    width, ``dv`` v's (``dh`` where None). ``body`` forces a body, for
    timing one against the other; nothing on the main path passes it."""
    dv = dh if dv is None else dv
    tc_ok = (dtype == torch.bfloat16 and S <= TC_MAX_SEQ
             and _tc_dims_ok(dh, dv, causal))
    v2_ok = dh == dv and dh <= MAX_HEAD_DIM and not causal
    if body is None:
        body = "tc" if tc_ok else "v2"
    if body not in _BODY_CODES or (body == "tc" and not tc_ok) or (
            body == "v2" and not v2_ok):
        raise ValueError(f"no {body!r} body for {dtype} at S={S}, dh={dh}, "
                         f"dv={dv}, causal={causal}")
    if body == "tc":
        # one warp per 16 query rows; a (batch item, head)'s query tiles
        # split over blocks of at most TC_BLOCK_WARPS warps, each block
        # with all its K and V as bf16 rows of dh + 8 and dv + 8 elements
        # and the key bias in fp32, padded to 16 * tiles keys
        tiles, splits, warps = _tc_split(S)
        return Plan("tc", B * H * splits, warps,
                    16 * tiles * (2 * (dh + dv + 16) + 4), aligned)
    # v2: R query rows per warp (the whole sequence in one tile where its
    # fp32 score rows fit their budget), then the largest key chunk of fp32
    # K/V rows (dh + 4 floats) beside the tile's q and score rows
    sp = (S + 3) & ~3
    rows = 1
    for r in _V2_ROWS:
        if _V2_WARPS * r * sp * 4 > _V2_SCORE_BYTES:
            break
        rows = r
        if _V2_WARPS * r >= S:
            break
    q_tile, ld = _V2_WARPS * rows, dh + 4
    fixed = 4 * (q_tile * dh + q_tile * sp)
    k_chunk = (_V2_SMEM_BYTES - fixed) // (4 * ld)
    k_chunk = S if k_chunk >= S else k_chunk & ~3
    return Plan("v2", B * H * -(-S // q_tile), _V2_WARPS,
                fixed + 4 * k_chunk * ld, aligned)


def _tc_split(S: int, block_warps: int = TC_BLOCK_WARPS):
    """The tc body's (16-row tiles, blocks per (batch item, head), warps
    per block) at sequence length S: the tiles split as evenly as blocks of
    at most ``block_warps`` warps allow (csrc/fused_attention.cu tc_splits,
    tc_block_threads)."""
    tiles = -(-S // 16)
    splits = -(-tiles // block_warps)
    return tiles, splits, -(-tiles // splits)


def _aligned16(*ts: torch.Tensor) -> bool:
    """Every row of every tensor starts on a 16-byte boundary: the base
    pointer and the batch, sequence and head strides in bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:3]) for t in ts)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, key_bias: torch.Tensor,
                              scale: float,
                              causal: bool = False) -> torch.Tensor:
    """The plain version, with the kernel's casts: q/k (B, S, H, dh), v
    (B, S, H, dv), key_bias (B, S) additive per key, ``causal`` masking
    key j > query i; returns (B, S, H, dv) in q.dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * scale + key_bias.float()[:, None, None, :]
    if causal:
        S = q.shape[1]
        future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check(q, k, v, key_bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if tuple(key_bias.shape) != (B, S):
        raise ValueError(f"key_bias must be {(B, S)}, got "
                         f"{tuple(key_bias.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"sequence length {S} outside 1..{MAX_SEQ}")
    dv = v.shape[3]
    if (dh, dv) != (MLA_QK_DIM, MLA_V_DIM) and (
            dh != dv or dh % 8 or not 8 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"head dims {dh}/{dv} must be equal multiples of 8 "
                         f"up to {MAX_HEAD_DIM}, or "
                         f"{MLA_QK_DIM}/{MLA_V_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v head dimension must be contiguous")
    devices = {t.device for t in (q, k, v, key_bias)}
    if len(devices) != 1:
        raise ValueError(f"q/k/v/key_bias on different devices: {devices}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, scale: float,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale + key_bias [+ causal mask]) v.

    q/k: (B, S, H, dh), v: (B, S, H, dv), float32 or bfloat16, last
    dimension contiguous, any other strides (e.g. slices of one merged QKV
    tensor); dv == dh, or (dh, dv) = (MLA_QK_DIM, MLA_V_DIM). key_bias:
    (B, S) additive bias per KEY position (HF's (1-mask)*-10000), cast to
    fp32. ``causal`` also masks every key after the query. Returns a new
    contiguous (B, S, H, dv) tensor in q.dtype.
    """
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, key_bias, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, key_bias, scale, causal=causal)


def fused_attention_shard_heads(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, key_bias: torch.Tensor,
                                scale: float, mesh,
                                num_heads: int) -> torch.Tensor:
    """The fused core on a tensor-parallel mesh (port of
    clipbert_tpu/ops/pallas_attention.py::fused_attention_shard_heads).

    The JAX function shard_maps the Pallas kernel over (data: batch, model:
    heads), and each device runs it on its (batch shard x head shard) with
    no collective. Here each rank already holds its shard: q/k/v are this
    rank's ``(B_local, S, num_heads / n_model, dh)`` views (under the
    Megatron split, strided slices of the rank's merged QKV projection) and
    key_bias its ``(B_local, S)`` rows. The same hand-written kernel
    (:func:`fused_attention`) runs on the local heads; nothing is
    communicated, since attention is independent per head.

    ``num_heads`` is the global head count: it must split over the model
    axis, and q must hold this rank's share of it. The batch was split
    where the global batch is known (train/steps.py::make_text_prob_step
    checks ``B_t % n_data``)."""
    n_model = mesh.n_model
    if num_heads % n_model:
        raise ValueError(f"{num_heads} heads do not split over {n_model} "
                         "model ranks")
    if q.dim() != 4 or q.shape[2] != num_heads // n_model:
        raise ValueError(f"q {tuple(q.shape)} does not hold this rank's "
                         f"{num_heads // n_model} of {num_heads} heads")
    global SHARD_HEADS_LAUNCHES
    out = fused_attention(q, k, v, key_bias, scale)
    if q.device.type == "cuda":
        SHARD_HEADS_LAUNCHES += 1
    return out


# clipbert_fused_attention's parameters (csrc/fused_attention.cu): q, k, v,
# key_bias, out; dtype, body, B, S, H, dh, dv, causal; the 9 strides;
# scale; the plan's blocks, threads, shared-memory bytes and vec; the stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("fused_attention").clipbert_fused_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, key_bias, scale: float,
            body: Optional[str] = None, causal: bool = False) -> torch.Tensor:
    """Launch the kernel on CUDA operands that passed :func:`_check`;
    ``body`` is :func:`_plan`'s, for timing the bodies in turns."""
    global LAUNCHES, TC_LAUNCHES
    refuse_autograd("fused_attention", q, k, v, key_bias)
    B, S, H, dh = q.shape
    dv = v.shape[3]
    plan = _plan(B, S, H, dh, q.dtype, _aligned16(q, k, v), body, dv, causal)
    bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
                       _BODY_CODES[plan.body], B, S, H, dh, dv, int(causal),
                       *strides,
                       float(scale), plan.grid, 32 * plan.warps,
                       plan.smem_bytes, int(plan.vec), stream)
    if rc == _PLAN_MISMATCH:
        raise RuntimeError(f"fused_attention: the kernel derives another "
                           f"launch than {plan}")
    if rc != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    if plan.body == "tc":
        TC_LAUNCHES += 1
    return out
