"""1x1 convolution as a GEMM with the frozen-BN / residual / ReLU epilogue
fused: the CUDA kernel's wrappers, its plain PyTorch version and its launch
counters.

Port of clipbert_tpu/ops/pallas_kernels.py (``matmul_bn_act`` and its NHWC
wrapper ``conv1x1_bn_act``): ``act((x @ w) * scale[n] + bias[n]
[+ residual])`` with fp32 accumulation, scale and bias in fp32, the
residual widened to fp32, ReLU, and one rounding to x's dtype. The kernel
(``csrc/matmul_bn_act.cu``) applies the epilogue to the fp32 accumulators
before its one store; the unfused form (cuDNN conv, then a bias pass, a
residual pass and a ReLU pass) writes and re-reads the (R, N) activation
three or four times.

The source has two hand-written bodies, and :func:`_plan` chooses one:
``"wg"`` (``wgmma`` fed by a TMA ring in persistent blocks, the residual
in and the output out through shared memory by TMA) for bf16 operands that
TMA can describe, which is every 1x1 conv of the main path; ``"mma"`` (the
first design, ``mma.sync`` tiles, and fp32 on the CUDA cores) for fp32, K or
N not a multiple of 8, rows off 16-byte alignment, and a stride that does
not divide H or W. ``WG_LAUNCHES`` counts the wg body's launches.

A strided 1x1 conv is not sliced first, as the JAX wrapper does
(``pallas_kernels.py:152-153``): the kernel takes the pixel stride and
reads only the kept pixels, which saves one pass over the input.

``scale`` may be None: the frozen-BN scale was folded into the weight
(models/resnet.py::fold_bn_scales), and the epilogue multiplies by 1.
``bias`` may be None (a bias-free dense product): the epilogue adds 0.

``ops/linear.py::dense`` runs BERT's and the heads' bf16 products through
:func:`matmul_bn_act` (``scale`` None, no residual, no ReLU): the epilogue
then adds the fp32 bias to the fp32 accumulators and rounds once, so the
unfused fp32 product, its bias pass and its cast pass never run. At their
widths the wg body's plan takes 256-wide tiles (:func:`_wg_tile_n`).

Routing: a CPU tensor takes :func:`matmul_bn_act_reference`; a CUDA tensor
launches the planned body or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from clipbert_tpu_torch.ops import refuse_autograd

# Kernel launches on the card since the process started (or since a caller
# reset it). Incremented only where the CUDA kernel is launched; WG_LAUNCHES
# counts those of the wgmma body (in LAUNCHES too). A CUDA graph's capture
# counts nothing and each replay what the graph recorded
# (utils/cuda_graphs.py).
LAUNCHES = 0
WG_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODES = {"mma": 0, "wg": 1}
_PLAN_MISMATCH = -1        # csrc/matmul_bn_act.cu kPlanMismatch
_TENSOR_MAP_FAILED = -2    # kTensorMapFailed
# the mma body's fixed tile and block (csrc/matmul_bn_act.cu BM, BN,
# kThreads)
_MMA_TILE = 128
_MMA_THREADS = 256
# the wg body (kBM, kBK, kSubN, kEpiSlots, kMaxStages, kSmemBudget, kAlign,
# kBarrierBytes, kWgThreads): 128-row tiles of BN columns, K 64 per stage,
# the epilogue's 4 slots of 128 x 64 bf16, the ring in what is left of a
# block's 227 KB
_WG_BM = 128
_WG_BK = 64
_WG_SUB_N = 64
_WG_EPI_SLOTS = 4
_WG_MAX_STAGES = 8
_WG_SMEM_BUDGET = 232448
_WG_ALIGN = 1024
_WG_BARRIER_BYTES = 256
_WG_THREADS = 384
WG_TILE_NS = (64, 128, 256)
# when the wg body takes 256-wide tiles (kWideMinN, kWideMinK, kWideMaxK,
# kWideWaves)
_WG_WIDE_MIN_N = 768
_WG_WIDE_MIN_K = 768
_WG_WIDE_MAX_K = 1024
_WG_WIDE_WAVES = 8


class Plan(NamedTuple):
    """One launch: the body, its grid (blocks), threads per block, dynamic
    shared-memory bytes per block, the output tile's width BN and the
    number of shared-memory stages of the wg body's ring."""
    body: str
    grid: int
    threads: int
    smem_bytes: int
    tile_n: int
    stages: int


def _wg_stages(tile_n: int) -> int:
    room = (_WG_SMEM_BUDGET - _WG_ALIGN - _WG_BARRIER_BYTES
            - _WG_EPI_SLOTS * _WG_BM * _WG_SUB_N * 2)
    return min(room // ((_WG_BM + tile_n) * _WG_BK * 2), _WG_MAX_STAGES)


def _wg_smem_bytes(tile_n: int) -> int:
    return (_WG_ALIGN + _wg_stages(tile_n) * (_WG_BM + tile_n) * _WG_BK * 2
            + _WG_EPI_SLOTS * _WG_BM * _WG_SUB_N * 2 + _WG_BARRIER_BYTES)


def _wg_tile_n(R: int, K: int, N: int, n_sms: int) -> int:
    """BN for an (R, K) x (K, N) product (csrc wg_tile_n): 64 pads nothing
    at N = 64; 256 where N >= 768, 768 <= K <= 1024 and the 256-wide tiles
    fill the card 8 times over; 128 elsewhere. On an H100, 256 ran BERT's
    K = 768 products at the retrieval eval's 565,248 rows 1.6-8% faster
    than 128, and was slower at K = 3072 (its tiles in flight hold more A
    rows than L2 keeps), at VQA's 5,248 rows (fewer tiles than waves
    balance) and at R50's K = 256 and 512 (a K loop too short for the
    3-stage ring to cover an epilogue)."""
    if N <= 64:
        return 64
    wide_tiles = -(-R // _WG_BM) * -(-N // 256)
    wide = (N >= _WG_WIDE_MIN_N and _WG_WIDE_MIN_K <= K <= _WG_WIDE_MAX_K
            and wide_tiles >= _WG_WIDE_WAVES * n_sms)
    return 256 if wide else 128


def _wg_ok(dtype, R, K, N, stride, in_h, in_w, out_w, aligned) -> bool:
    """What TMA can describe (csrc wg_ok): bf16, K and N multiples of 8
    (16-byte strides), 16-byte aligned bases, coordinates within 32 bits,
    and for a strided conv H and W divisible by the stride with whole output
    rows fitting a 128-row tile."""
    return (dtype == torch.bfloat16 and aligned and K % 8 == 0
            and N % 8 == 0 and R + _WG_BM <= 2 ** 31 - 1
            and (stride == 1 or (in_h % stride == 0 and in_w % stride == 0
                                 and out_w <= _WG_BM)))


def _plan(R: int, K: int, N: int, stride: int, in_h: int, in_w: int,
          out_w: int, dtype: torch.dtype, aligned: bool, n_sms: int,
          body: Optional[str] = None,
          tile_n: Optional[int] = None) -> Plan:
    """The launch the C entry point makes for these operands (it derives
    the same plan and refuses a different one). ``body`` and ``tile_n``
    force a body and a tile width, for timing one against another; nothing
    on the main path passes them."""
    wg_ok = _wg_ok(dtype, R, K, N, stride, in_h, in_w, out_w, aligned)
    if body is None:
        body = "wg" if wg_ok else "mma"
    elif body not in _BODY_CODES or (body == "wg" and not wg_ok):
        raise ValueError(f"no {body!r} body for {dtype} at R={R}, K={K}, "
                         f"N={N}, stride={stride}")
    if body == "mma":
        if tile_n not in (None, _MMA_TILE):
            raise ValueError(f"the mma body's tile is {_MMA_TILE} wide")
        tiles = -(-R // _MMA_TILE) * -(-N // _MMA_TILE)
        return Plan("mma", tiles, _MMA_THREADS, 0, _MMA_TILE, 1)
    if tile_n is None:
        tile_n = _wg_tile_n(R, K, N, n_sms)
    elif tile_n not in WG_TILE_NS:
        raise ValueError(f"no wg tile {tile_n} wide: {WG_TILE_NS}")
    if stride == 1:
        num_m = -(-R // _WG_BM)
    else:                       # whole output rows, 128 // out_w a tile
        num_m = -(-(R // out_w) // (_WG_BM // out_w))
    tiles = num_m * -(-N // tile_n)
    return Plan("wg", min(tiles, n_sms), _WG_THREADS, _wg_smem_bytes(tile_n),
                tile_n, _wg_stages(tile_n))


def _aligned16(*ts: Optional[torch.Tensor]) -> bool:
    """Every operand's base pointer on a 16-byte boundary (each is
    contiguous, and K and N decide the row strides)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


@functools.cache
def _n_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def matmul_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                            scale: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor],
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = True) -> torch.Tensor:
    """The plain version, with the kernel's casts: x (R, K), w (K, N) (cast
    to x's dtype, as the JAX wrapper casts its kernel), scale/bias (N,),
    residual (R, N); returns (R, N) in x.dtype."""
    acc = x.float() @ w.to(x.dtype).float()
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype)


def _check(x, w, K, N, scale, bias, residual, rows) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if (bias is not None and tuple(bias.shape) != (N,)) or (
            scale is not None and tuple(scale.shape) != (N,)):
        raise ValueError(f"scale/bias must be ({N},)")
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} input channels, w has {K}")
    if residual is not None:
        if tuple(residual.shape) != rows + (N,):
            raise ValueError(f"residual must be {rows + (N,)}, got "
                             f"{tuple(residual.shape)}")
        if residual.dtype != x.dtype:
            raise ValueError(f"residual dtype {residual.dtype} != x dtype "
                             f"{x.dtype}")
    tensors = [t for t in (x, w, scale, bias, residual) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul_bn_act runs on cpu or cuda, not "
                         f"{x.device}")


def matmul_bn_act(x: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor],
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> torch.Tensor:
    """act((x @ w) * scale + bias [+ residual]) with one rounding.

    x: (R, K) float32 or bfloat16; w: (K, N), any float dtype (cast to x's),
    any strides; scale and bias: (N,) or None; residual: (R, N) in x's
    dtype or None. Returns a new (R, N) tensor in x.dtype.
    """
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x must be (R, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    K, N = w.shape
    _check(x, w, K, N, scale, bias, residual, (x.shape[0],))
    if x.device.type == "cpu":
        return matmul_bn_act_reference(x, w, scale, bias, residual, relu)
    R = x.shape[0]
    out = _launch(x.contiguous(), w.t(), scale, bias, residual, relu,
                  (R, 1, 1), 1)
    return out.reshape(R, N)


def conv1x1_bn_act(x: torch.Tensor, weight: torch.Tensor,
                   scale: Optional[torch.Tensor], bias: torch.Tensor,
                   stride: int = 1, residual: Optional[torch.Tensor] = None,
                   relu: bool = True) -> torch.Tensor:
    """Fused 1x1 conv + frozen BN + optional residual + ReLU, NHWC.

    x: (B, H, W, Cin); weight: the port's OIHW conv weight (Cout, Cin, 1, 1)
    or (Cout, Cin); residual: (B, Ho, Wo, Cout) with Ho = ceil(H / stride).
    Returns a new contiguous (B, Ho, Wo, Cout) tensor in x.dtype.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    w_nk = weight.reshape(weight.shape[0], -1)
    N, K = w_nk.shape
    B, H, W, _ = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    _check(x, weight, K, N, scale, bias, residual, (B, Ho, Wo))
    if x.device.type == "cpu":
        xs = x[:, ::stride, ::stride, :].reshape(B * Ho * Wo, K)
        res = None if residual is None else residual.reshape(-1, N)
        out = matmul_bn_act_reference(xs, w_nk.t(), scale, bias, res, relu)
        return out.reshape(B, Ho, Wo, N)
    return _launch(x.contiguous(), w_nk, scale, bias, residual, relu,
                   (B, H, W), stride)


# clipbert_matmul_bn_act's parameters (csrc/matmul_bn_act.cu): x, w,
# scale, bias, residual, out; dtype, R, K, N, stride, in_h, in_w, out_h,
# out_w, relu; the plan's body, tile_n, whether they were forced, the SM
# count, grid, threads, shared-memory bytes and stages; the stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
             + [ctypes.c_int] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("matmul_bn_act").clipbert_matmul_bn_act
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w_nk, scale, bias, residual, relu: bool, bhw, stride: int,
            body: Optional[str] = None, tile_n: Optional[int] = None):
    """x: contiguous (B, H, W, K) (or (R, K) with bhw = (R, 1, 1));
    w_nk: (N, K). Returns (B, Ho, Wo, N). ``body`` and ``tile_n`` are
    :func:`_plan`'s, for timing the bodies and tile widths in turns."""
    global LAUNCHES, WG_LAUNCHES
    refuse_autograd("matmul_bn_act", x, w_nk, scale, bias, residual)
    B, H, W = bhw
    N, K = w_nk.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    R = B * Ho * Wo
    w_nk = w_nk.to(x.dtype).contiguous()
    sc = None if scale is None else scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    res = None if residual is None else residual.contiguous()
    out = torch.empty((B, Ho, Wo, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return out                      # nothing to launch, nothing counted
    n_sms = _n_sms(x.device.index if x.device.index is not None
                   else torch.cuda.current_device())
    plan = _plan(R, K, N, stride, H, W, Wo, x.dtype,
                 _aligned16(x, w_nk, res, out), n_sms, body, tile_n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w_nk.data_ptr(),
                       None if sc is None else sc.data_ptr(),
                       None if b is None else b.data_ptr(),
                       None if res is None else res.data_ptr(),
                       out.data_ptr(), _DTYPE_CODES[x.dtype], R, K, N,
                       stride, H, W, Ho, Wo, int(relu),
                       _BODY_CODES[plan.body], plan.tile_n,
                       int(body is not None or tile_n is not None), n_sms,
                       plan.grid, plan.threads, plan.smem_bytes, plan.stages,
                       stream)
    if rc == _PLAN_MISMATCH:
        raise RuntimeError(f"matmul_bn_act: the kernel derives another "
                           f"launch than {plan}")
    if rc == _TENSOR_MAP_FAILED:
        raise RuntimeError(f"matmul_bn_act: the driver refused a tensor map "
                           f"for {plan}")
    if rc != 0:
        raise RuntimeError(f"matmul_bn_act kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    if plan.body == "wg":
        WG_LAUNCHES += 1
    return out
