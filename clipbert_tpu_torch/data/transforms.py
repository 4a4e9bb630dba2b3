"""Device resize + pad + normalize (port of the device half of
clipbert_tpu/data/transforms.py).

Reference contracts: resize the longer side to max_size, bilinear with
align_corners=False (`data_utils.py:230-233`, get_resize_size :166-197 with
int truncation); zero-pad at bottom/right to (max, max)
(`data_utils.py:112-160`); ImageNorm with the div-255 guard
(`data_utils.py:256-276`).

The resize is two batched products per frame, ``out = R_h @ frame @
R_w^T``, with interpolation matrices built on the device from the per-item
source sizes; rows past the resize target are zero, which is the pad.
Native-size uint8 frames cross to the device, not 448^2 floats.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from clipbert_tpu_torch.ops.linear import bmm_f32


def get_resize_size(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """Longer side -> max_size keeping aspect ratio; int truncation exactly
    as the reference (data_utils.py:166-197)."""
    if h >= w:
        new_h = max_size
        new_w = new_h * (w * 1.0 / h)
    else:
        new_w = max_size
        new_h = new_w * (h * 1.0 / w)
    return int(new_h), int(new_w)


# reference configs (RGB order; the RGB->BGR flip is folded into imported
# stem-conv weights)
IMAGENET_MEAN_255 = (123.675, 116.28, 103.53)
IMAGENET_STD_1 = (1.0, 1.0, 1.0)

_BUCKET = 64   # native frames zero-pad up to this granularity (serve.py)


def _normalize(x: torch.Tensor, mean: Sequence[float],
               std: Sequence[float], compute_dtype) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    if max(mean) <= 1.0:
        x = x / 255.0
    return ((x - mean_t) / std_t).to(compute_dtype)


def normalize_pixels(frames: torch.Tensor,
                     mean: Sequence[float] = IMAGENET_MEAN_255,
                     std: Sequence[float] = IMAGENET_STD_1,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized compute-dtype pixels (ImageNorm,
    including the div-255 guard for a <=1 mean)."""
    return _normalize(frames.float(), mean, std, compute_dtype)


def _resize_weights(src: torch.Tensor, new: torch.Tensor, out_size: int,
                    buf_size: int) -> torch.Tensor:
    """(B,) source sizes + (B,) resize targets -> (B, out_size, buf_size)
    fp32 bilinear weights with ``interpolate(align_corners=False)``
    semantics (half-pixel centers, lower clamp to 0, edge replicate at the
    top), zero rows for i >= new (the pad region)."""
    srcf = src.float()[:, None]
    newf = new.float()[:, None]
    i = torch.arange(out_size, dtype=torch.float32, device=src.device)[None, :]
    pos = (i + 0.5) * (srcf / newf) - 0.5
    pos = torch.minimum(pos.clamp(min=0.0), srcf - 1.0)        # (B, out)
    k = torch.arange(buf_size, dtype=torch.float32, device=src.device)
    w = (1.0 - (pos[:, :, None] - k[None, None, :]).abs()).clamp(min=0.0)
    return torch.where((i < newf)[:, :, None], w, 0.0)


def resize_pad_normalize(frames: torch.Tensor, src_hw: torch.Tensor,
                         out_size: int,
                         mean: Sequence[float] = IMAGENET_MEAN_255,
                         std: Sequence[float] = IMAGENET_STD_1,
                         compute_dtype=torch.bfloat16,
                         exact: bool = False) -> torch.Tensor:
    """Device resize (longer side -> out_size) + zero-pad + ImageNorm.

    frames: (B, T, Hbuf, Wbuf, 3) uint8, native frames packed into a buffer
    bucket. src_hw: (B, 4) int, [native_h, native_w, new_h, new_w] per item
    (targets from :func:`get_resize_size`). Returns (B, T, out_size,
    out_size, 3) in compute_dtype.

    exact=False: bf16 operands with fp32 accumulation; the first product is
    rounded to bf16, the second kept in fp32 (the JAX production recipe).
    exact=True: fp32 throughout (the parity oracle).
    """
    B, T, Hb, Wb, C = frames.shape
    S = out_size
    dt = torch.float32 if exact else torch.bfloat16
    rh = _resize_weights(src_hw[:, 0], src_hw[:, 2], S, Hb).to(dt)
    rw = _resize_weights(src_hw[:, 1], src_hw[:, 3], S, Wb).to(dt)
    rh = rh[:, None].expand(B, T, S, Hb).reshape(B * T, S, Hb)
    rw = rw[:, None].expand(B, T, S, Wb).reshape(B * T, S, Wb)
    # rows: (BT, S, Hb) @ (BT, Hb, Wb*C) -> (BT, S, Wb*C)
    x = bmm_f32(rh, frames.to(dt).reshape(B * T, Hb, Wb * C))
    # columns: out[bt, i, j, c] = sum_w rw[bt, j, w] x[bt, i, w, c]
    x = x.to(dt).reshape(B * T, S, Wb, C).transpose(1, 2)
    x = bmm_f32(rw, x.reshape(B * T, Wb, S * C))              # (BT, j, i*C)
    x = x.reshape(B, T, S, S, C).transpose(2, 3)               # (B,T,i,j,C)
    return _normalize(x, mean, std, compute_dtype).contiguous()


def device_preprocess(frames: np.ndarray, src_hw: np.ndarray, out_size: int,
                      mean=IMAGENET_MEAN_255, std=IMAGENET_STD_1,
                      compute_dtype=torch.bfloat16, exact: bool = False, *,
                      device: torch.device | str) -> torch.Tensor:
    """Host uint8 frames (B, T, Hbuf, Wbuf, 3) + (B, 4) src_hw -> normalized
    pixels on ``device``; only the uint8 buffer crosses to the device."""
    f = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    hw = torch.from_numpy(np.asarray(src_hw, np.int64)).to(device)
    return resize_pad_normalize(f, hw, int(out_size), mean, std,
                                compute_dtype, exact)
