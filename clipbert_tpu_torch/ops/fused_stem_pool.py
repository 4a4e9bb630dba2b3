"""Fused ResNet stem: conv 7x7/s2 + frozen-BN bias + ReLU + maxpool 3x3/s2
in one pass. The CUDA kernel's wrapper, its plain PyTorch version and its
launch counter.

Port of clipbert_tpu/ops/pallas_stem.py::fused_stem_pool: the conv sums its
147 taps in fp32 (input widened, weights rounded to the input dtype, as the
JAX wrapper casts its packed weights), + bias, ReLU, max over the 3x3/s2
window with pad 1, one rounding to the input dtype. The pool's zero padding
equals -inf padding only because the pool runs after ReLU (every value is
>= 0) and every window holds at least one real conv output
(pallas_stem.py:37-39). The kernel (``csrc/fused_stem_pool.cu``) keeps the
(B, H/2, W/2, 64) conv activation in shared memory and writes only the
pooled output. The TPU kernel's space-to-depth^3 packing is a layout device
for the TPU's matrix unit and is not ported; unlike it, the kernel takes
any H, W >= 1.

The source has two hand-written bodies, and :func:`_plan` chooses one:
``"tc"`` (the conv as an implicit GEMM on the tensor cores, ``mma.sync``
with bf16 operands and fp32 sums, one persistent block an SM working on
two 8 x 7 pooled tiles at a time) for bf16 with 16-byte aligned input and
output, which is the main path; ``"direct"`` (the first design, a direct
convolution on the fp32 CUDA cores) for fp32 and the rest.
``TC_LAUNCHES`` counts the tc body's launches.

Routing: a CPU tensor takes :func:`fused_stem_pool_reference`; a CUDA
tensor launches the planned body or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from clipbert_tpu_torch.ops import refuse_autograd
from clipbert_tpu_torch.ops.matmul_bn_act import _aligned16, _n_sms

# Kernel launches on the card since the process started (or since a caller
# reset it). Incremented only where the CUDA kernel is launched; TC_LAUNCHES
# counts those of the tensor-core body (in LAUNCHES too). A CUDA graph's
# capture counts nothing and each replay what the graph recorded
# (utils/cuda_graphs.py).
LAUNCHES = 0
TC_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODES = {"direct": 0, "tc": 1}
_PLAN_MISMATCH = -1        # csrc/fused_stem_pool.cu kPlanMismatch
# the direct body (PH, PW, kThreads, kSmemFloats * 4): 7 x 8 pooled outputs
# a block, the weights, the fp32 input halo and the column-pooled tile in
# shared memory
_DIRECT_TILE = (7, 8)
_DIRECT_THREADS = 256
_DIRECT_SMEM = (147 * 64 + 4096 + 15 * 8 * 64) * 4
# the tc body (kTcPH, kTcPW, kTcGroups, kTcThreads, kTcSmem): 8 x 7 pooled
# outputs a tile; one persistent block an SM, two tiles in flight a block
# (a group of 4 warps each); the [64][168] bf16 weight, the bias and the
# tap offsets shared, and per group two input halo buffers of 39 rows x 112
# bf16 and the [255][64] bf16 conv tile
_TC_TILE = (8, 7)
_TC_GROUPS = 2
_TC_THREADS = 256
_TC_SMEM = (64 * 168 * 2 + 64 * 4 + 10 * 4 * 8
            + _TC_GROUPS * (2 * 39 * 112 * 2 + 255 * 64 * 2))


class Plan(NamedTuple):
    """One launch: the body, its grid (blocks), threads per block, dynamic
    shared-memory bytes per block and the pooled tile (rows, columns) a
    block computes at a time."""
    body: str
    grid: int
    threads: int
    smem_bytes: int
    tile: Tuple[int, int]


def _out_hw(H: int, W: int) -> Tuple[int, int]:
    """Pooled rows and columns: conv 7x7 / 2 pad 3, then pool 3x3 / 2 pad
    1, each ceil(n / 2)."""
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1


def _plan(B: int, H: int, W: int, dtype: torch.dtype, aligned: bool,
          n_sms: int, body: Optional[str] = None) -> Plan:
    """The launch the C entry point makes for these operands (it derives
    the same plan and refuses a different one). ``aligned``: x and out on
    16-byte boundaries. ``body`` forces a body, for timing one against the
    other; nothing on the main path passes it."""
    tc_ok = dtype == torch.bfloat16 and aligned
    if body is None:
        body = "tc" if tc_ok else "direct"
    elif body not in _BODY_CODES or (body == "tc" and not tc_ok):
        raise ValueError(f"no {body!r} body for {dtype} at {(B, H, W)}, "
                         f"aligned={aligned}")
    Hp, Wp = _out_hw(H, W)
    if body == "direct":
        ph, pw = _DIRECT_TILE
        return Plan("direct", -(-Hp // ph) * -(-Wp // pw) * B,
                    _DIRECT_THREADS, _DIRECT_SMEM, _DIRECT_TILE)
    ph, pw = _TC_TILE
    tiles = -(-Hp // ph) * -(-Wp // pw) * B
    return Plan("tc", min(-(-tiles // _TC_GROUPS), n_sms), _TC_THREADS,
                _TC_SMEM, _TC_TILE)


def fused_stem_pool_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """The plain version, with the kernel's casts: x (B, H, W, 3), weight
    (64, 3, 7, 7) with the BN scale folded in, bias (64,); returns
    (B, Hp, Wp, 64) in x.dtype."""
    w = weight.to(x.dtype).float()
    h = F.conv2d(x.permute(0, 3, 1, 2).float(), w, None, 2, 3)
    h = torch.relu(h + bias.float()[None, :, None, None])
    h = F.max_pool2d(h, 3, 2, 1)
    return h.permute(0, 2, 3, 1).to(x.dtype)


def _check(x, weight, bias) -> None:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, H, W, 3), got {tuple(x.shape)}")
    if tuple(weight.shape) != (64, 3, 7, 7) or tuple(bias.shape) != (64,):
        raise ValueError(f"weight must be (64, 3, 7, 7) and bias (64,), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    devices = {t.device for t in (x, weight, bias)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stem_pool runs on cpu or cuda, not "
                         f"{x.device}")


def fused_stem_pool(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels -> (B, Hp, Wp, 64) pooled stem activations, with
    Hc = ceil(H / 2) conv rows and Hp = ceil(Hc / 2) pooled rows (H / 4 for
    H divisible by 4).

    weight: the folded stem conv weight (64, 3, 7, 7), OIHW; bias: (64,).
    Returns a new contiguous tensor in x.dtype.
    """
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return fused_stem_pool_reference(x, weight, bias)
    return _launch(x.contiguous(), weight, bias)


# clipbert_fused_stem_pool's parameters (csrc/fused_stem_pool.cu): x, w,
# bias, out; dtype, B, H, W; the plan's body, whether it was forced, the SM
# count, grid, threads and shared-memory bytes; the stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("fused_stem_pool").clipbert_fused_stem_pool
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, bias, body: Optional[str] = None) -> torch.Tensor:
    """x: contiguous (B, H, W, 3). ``body`` is :func:`_plan`'s, for timing
    the bodies in turns."""
    global LAUNCHES, TC_LAUNCHES
    refuse_autograd("fused_stem_pool", x, weight, bias)
    B, H, W, _ = x.shape
    Hp, Wp = _out_hw(H, W)
    out = torch.empty((B, Hp, Wp, 64), dtype=x.dtype, device=x.device)
    n_sms = _n_sms(x.device.index if x.device.index is not None
                   else torch.cuda.current_device())
    plan = _plan(B, H, W, x.dtype, _aligned16(x, out), n_sms, body)
    if plan.body == "tc":
        # the folded OIHW weight as fp32 on a 16-byte boundary: the kernel
        # reads it in 16-byte loads and rounds it to bf16 itself
        w = weight.to(torch.float32).contiguous()
        if not _aligned16(w):
            w = w.clone()
    else:
        # [c][ky][kx][out channel], values rounded to x's dtype, as fp32
        w = weight.to(x.dtype).to(torch.float32).permute(1, 2, 3,
                                                         0).contiguous()
    b = bias.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                       out.data_ptr(), _DTYPE_CODES[x.dtype], B, H, W,
                       _BODY_CODES[plan.body], int(body is not None), n_sms,
                       plan.grid, plan.threads, plan.smem_bytes, stream)
    if rc == _PLAN_MISMATCH:
        raise RuntimeError(f"fused_stem_pool: the kernel derives another "
                           f"launch than {plan}")
    if rc != 0:
        raise RuntimeError(f"fused_stem_pool kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    if plan.body == "tc":
        TC_LAUNCHES += 1
    return out
