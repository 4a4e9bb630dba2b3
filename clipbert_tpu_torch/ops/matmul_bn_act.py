"""1x1 convolution as a GEMM with the frozen-BN / residual / ReLU epilogue
fused: the CUDA kernel's wrappers, its plain PyTorch version and its launch
counter.

Port of clipbert_tpu/ops/pallas_kernels.py (``matmul_bn_act`` and its NHWC
wrapper ``conv1x1_bn_act``): ``act((x @ w) * scale[n] + bias[n]
[+ residual])`` with fp32 accumulation, scale and bias in fp32, the
residual widened to fp32, ReLU, and one rounding to x's dtype. The kernel
(``csrc/matmul_bn_act.cu``) runs the products on the tensor cores
(``mma.sync`` bf16, fp32 accumulators) and applies the epilogue to the
accumulator registers before its one store; the unfused form (cuDNN conv,
then a bias pass, a residual pass and a ReLU pass) writes and re-reads the
(R, N) activation three or four times.

A strided 1x1 conv is not sliced first, as the JAX wrapper does
(``pallas_kernels.py:152-153``): the kernel takes the pixel stride and
reads only the kept pixels, which saves one pass over the input.

``scale`` may be None: the frozen-BN scale was folded into the weight
(models/resnet.py::fold_bn_scales), and the epilogue multiplies by 1.

Routing: a CPU tensor takes :func:`matmul_bn_act_reference`; a CUDA tensor
launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

# Kernel launches since the process started (or since a caller reset it).
# Incremented only where the CUDA kernel is launched.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                            scale: Optional[torch.Tensor], bias: torch.Tensor,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = True) -> torch.Tensor:
    """The plain version, with the kernel's casts: x (R, K), w (K, N) (cast
    to x's dtype, as the JAX wrapper casts its kernel), scale/bias (N,),
    residual (R, N); returns (R, N) in x.dtype."""
    acc = x.float() @ w.to(x.dtype).float()
    if scale is not None:
        acc = acc * scale.float()
    acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(x.dtype)


def _check(x, w, K, N, scale, bias, residual, rows) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if tuple(bias.shape) != (N,) or (scale is not None
                                     and tuple(scale.shape) != (N,)):
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
                  scale: Optional[torch.Tensor], bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> torch.Tensor:
    """act((x @ w) * scale + bias [+ residual]) with one rounding.

    x: (R, K) float32 or bfloat16; w: (K, N), any float dtype (cast to x's),
    any strides; scale (or None) and bias: (N,); residual: (R, N) in x's
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


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("matmul_bn_act").clipbert_matmul_bn_act
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w_nk, scale, bias, residual, relu: bool, bhw, stride: int):
    """x: contiguous (B, H, W, K) (or (R, K) with bhw = (R, 1, 1));
    w_nk: (N, K). Returns (B, Ho, Wo, N)."""
    global LAUNCHES
    B, H, W = bhw
    N, K = w_nk.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    R = B * Ho * Wo
    w_nk = w_nk.to(x.dtype).contiguous()
    sc = None if scale is None else scale.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    res = None if residual is None else residual.contiguous()
    out = torch.empty((B, Ho, Wo, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return out                      # nothing to launch, nothing counted
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w_nk.data_ptr(),
                       None if sc is None else sc.data_ptr(), b.data_ptr(),
                       None if res is None else res.data_ptr(),
                       out.data_ptr(), _DTYPE_CODES[x.dtype], R, K, N,
                       stride, H, W, Ho, Wo, int(relu), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_bn_act kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out
