"""Fused multi-head attention core: the CUDA kernel's wrapper, its plain
PyTorch version and its launch counter.

Port of clipbert_tpu/ops/pallas_attention.py::fused_attention:
``softmax(q k^T * scale + key_bias[b, key]) v`` with an exact full-row fp32
softmax, probabilities cast to v's dtype before PV, result in q's dtype.
The kernel (``csrc/fused_attention.cu``) keeps the score tile in shared
memory; the unfused form materializes a (B, H, S, S) fp32 score tensor in
device memory.

Routing: a CPU tensor takes :func:`fused_attention_reference`; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Kernel launches since the process started (or since a caller reset it).
# Incremented only where the CUDA kernel is launched; SHARD_HEADS_LAUNCHES
# counts those made through fused_attention_shard_heads (in LAUNCHES too).
LAUNCHES = 0
SHARD_HEADS_LAUNCHES = 0

MAX_SEQ = 640
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, key_bias: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """The plain version, with the kernel's casts: q/k/v (B, S, H, dh),
    key_bias (B, S) additive per key; returns (B, S, H, dh) in q.dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * scale + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check(q, k, v, key_bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    B, S, H, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
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
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q/k/v head dimension must be contiguous")
    devices = {t.device for t in (q, k, v, key_bias)}
    if len(devices) != 1:
        raise ValueError(f"q/k/v/key_bias on different devices: {devices}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + key_bias) v.

    q/k/v: (B, S, H, dh) float32 or bfloat16, last dimension contiguous,
    any other strides (e.g. slices of one merged QKV tensor). key_bias:
    (B, S) additive bias per KEY position (HF's (1-mask)*-10000), cast to
    fp32. Returns a new contiguous (B, S, H, dh) tensor in q.dtype.
    """
    _check(q, k, v, key_bias)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, key_bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, key_bias, scale)


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


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("fused_attention").clipbert_fused_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, key_bias, scale: float) -> torch.Tensor:
    global LAUNCHES
    B, S, H, dh = q.shape
    bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
                       B, S, H, dh, *strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
