"""Device resize + pad + normalize (port of the device half of
clipbert_tpu/data/transforms.py), and copies of its host numpy helpers
(``mask_text_tokens``, ``resize_frames``, ``pad_frames``,
``is_extreme_aspect_ratio``, ``collate_visual``, ``chunk_list``,
``mk_input_group``).

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

import functools
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clipbert_tpu_torch.ops.linear import bmm_f32


def mask_text_tokens(inputs: np.ndarray, special_tokens_mask: np.ndarray,
                     mask_token_id: int, vocab_size: int,
                     rng: np.random.Generator,
                     mlm_probability: float = 0.15,
                     pad_token_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """BERT MLM corruption (data_utils.py:23-70). Returns (inputs, labels);
    labels are -100 except at masked positions (original token kept there).

    inputs: (B, L) int array (already padded); modified copy returned.
    special_tokens_mask: (B, L) bool/int — 1 where CLS/SEP/special.
    """
    inputs = inputs.copy()
    labels = inputs.copy()
    prob = np.full(labels.shape, mlm_probability)
    prob[special_tokens_mask.astype(bool)] = 0.0
    prob[labels == pad_token_id] = 0.0
    masked = rng.random(labels.shape) < prob
    labels[~masked] = -100

    # 80%: [MASK]
    replaced = (rng.random(labels.shape) < 0.8) & masked
    inputs[replaced] = mask_token_id
    # 10%: random token
    randomized = (rng.random(labels.shape) < 0.5) & masked & ~replaced
    rand_words = rng.integers(0, vocab_size, labels.shape)
    inputs[randomized] = rand_words[randomized]
    # remaining 10%: keep
    return inputs, labels


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


def resize_frames(frames: np.ndarray, max_size: int) -> np.ndarray:
    """Bilinear resize, longer side -> max_size, align_corners=False.

    frames: (T, H, W, C) uint8 -> (T, H', W', C) uint8, through torch's
    interpolate on the host for exact parity with the reference transform
    (data_utils.py:230-233)."""
    T, H, W, C = frames.shape
    new_h, new_w = get_resize_size(H, W, max_size)
    if (new_h, new_w) == (H, W):
        return frames
    if not frames.flags.writeable:   # e.g. mmap-backed store views
        frames = frames.copy()
    t = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    t = torch.nn.functional.interpolate(
        t.float(), size=(new_h, new_w), mode="bilinear", align_corners=False)
    out = t.round_().clamp_(0, 255).byte().permute(0, 2, 3, 1).numpy()
    return np.ascontiguousarray(out)


def pad_frames(frames: np.ndarray, max_h: int, max_w: int) -> np.ndarray:
    """Zero-pad (T, H, W, C) at bottom/right to (T, max_h, max_w, C)
    (data_utils.py:112-133, keep image at upper-left corner)."""
    T, H, W, C = frames.shape
    if (H, W) == (max_h, max_w):
        return frames
    out = np.zeros((T, max_h, max_w, C), dtype=frames.dtype)
    out[:, :H, :W] = frames
    return out


def is_extreme_aspect_ratio(h: int, w: int, max_ratio: float = 5.0) -> bool:
    """dataset_base.py:228-233 guard."""
    r = h / float(w)
    return r > max_ratio or r < 1.0 / max_ratio


# reference configs (RGB order; the RGB->BGR flip is folded into imported
# stem-conv weights)
IMAGENET_MEAN_255 = (123.675, 116.28, 103.53)
IMAGENET_STD_1 = (1.0, 1.0, 1.0)

_BUCKET = 64   # native frames zero-pad up to this granularity (serve.py)


def collate_visual(batch: List[Dict]) -> Tuple[np.ndarray,
                                               Optional[np.ndarray]]:
    """Stack per-item visuals for a batch.

    Host-preprocessed items ({"vis": (T,S,S,3)}) stack directly. Native
    items ({"vis": (T,H,W,3), "vis_hw": (4,) int32}) are packed into a
    zero buffer bucket (max size rounded up to 64) for the device resize
    path; returns (buffer, (B,4) src_hw) in that case, else (stack, None).
    """
    if "vis_hw" not in batch[0]:
        return np.stack([d["vis"] for d in batch]), None
    vis = [d["vis"] for d in batch]
    hw = np.stack([d["vis_hw"] for d in batch]).astype(np.int32)
    Hb = -(-max(v.shape[1] for v in vis) // _BUCKET) * _BUCKET
    Wb = -(-max(v.shape[2] for v in vis) // _BUCKET) * _BUCKET
    T = vis[0].shape[0]
    buf = np.zeros((len(vis), T, Hb, Wb, vis[0].shape[3]), vis[0].dtype)
    for i, v in enumerate(vis):
        assert v.shape[0] == T, "clip count must be uniform within a batch"
        buf[i, :, :v.shape[1], :v.shape[2]] = v
    return buf, hw


# ---------------------------------------------------------------------------
# example grouping
# ---------------------------------------------------------------------------

def chunk_list(examples: List, chunk_size: int = 2,
               pad_to_divisible: bool = True,
               rng: Optional[random.Random] = None) -> List[List]:
    """data_utils.py:279-304: split into chunks, optionally padding the tail
    with random repeats so every chunk has exactly chunk_size items."""
    examples = list(examples)
    n = len(examples)
    remainder = n % chunk_size
    if pad_to_divisible and remainder > 0:
        picker = rng if rng is not None else random
        examples = examples + picker.choices(examples, k=chunk_size - remainder)
        n = len(examples)
        remainder = 0
    n_chunks = n // chunk_size + (1 if remainder > 0 else 0)
    return [examples[i * chunk_size:(i + 1) * chunk_size]
            for i in range(n_chunks)]


def mk_input_group(key_grouped_examples: Dict, max_n_example_per_group: int = 2,
                   is_train: bool = True,
                   example_unique_key: Optional[str] = None,
                   rng: Optional[random.Random] = None) -> List[Tuple]:
    """data_utils.py:307-341: (id, [examples]) groups of at most
    max_n_example_per_group texts per visual; train groups padded to exactly
    that size. With example_unique_key, asserts no example was dropped."""
    input_groups = []
    for k, examples in key_grouped_examples.items():
        for c in chunk_list(examples, max_n_example_per_group,
                            pad_to_divisible=is_train, rng=rng):
            input_groups.append((k, c))
    if example_unique_key is not None:
        inp = {e[example_unique_key]
               for exs in key_grouped_examples.values() for e in exs}
        out = {e[example_unique_key] for _, exs in input_groups for e in exs}
        assert inp == out, "example grouping dropped examples"
    return input_groups


@functools.lru_cache(maxsize=None)
def _norm_constants(mean: Tuple[float, ...], std: Tuple[float, ...],
                    device: torch.device):
    """The (mean, std) fp32 tensors on ``device``, made once: a host to
    device copy cannot run inside a CUDA graph's capture, and the first
    call of every captured encode runs eagerly first."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def _normalize(x: torch.Tensor, mean: Sequence[float],
               std: Sequence[float], compute_dtype) -> torch.Tensor:
    mean_t, std_t = _norm_constants(tuple(mean), tuple(std), x.device)
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
    pixels on ``device``; only the uint8 buffer crosses to the device. The
    copy is the host's part; :func:`resize_pad_normalize` is the device's,
    which the scorers capture in a CUDA graph that reads static buffers
    the copy fills (serve.py, utils/cuda_graphs.py)."""
    f = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    hw = torch.from_numpy(np.asarray(src_hw, np.int64)).to(device)
    return resize_pad_normalize(f, hw, int(out_size), mean, std,
                                compute_dtype, exact)
