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

Routing: a CPU tensor takes :func:`fused_stem_pool_reference`; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# Kernel launches since the process started (or since a caller reset it).
# Incremented only where the CUDA kernel is launched.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.cache
def _kernel():
    from clipbert_tpu_torch.ops import _build
    fn = _build.load_library("fused_stem_pool").clipbert_fused_stem_pool
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, bias) -> torch.Tensor:
    global LAUNCHES
    B, H, W, _ = x.shape
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    Hp, Wp = (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1
    # [c][ky][kx][out channel], values rounded to x's dtype, held as fp32
    w = weight.to(x.dtype).to(torch.float32).permute(1, 2, 3, 0).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty((B, Hp, Wp, 64), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                       out.data_ptr(), _DTYPE_CODES[x.dtype], B, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"fused_stem_pool kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
