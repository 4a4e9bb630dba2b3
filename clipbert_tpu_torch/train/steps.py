"""Inference scoring steps (port of clipbert_tpu/train/steps.py, the parts
the retrieval serving path runs).

The JAX steps are jitted programs memoized per configuration; here a step
is a plain closure run eagerly under ``torch.inference_mode``. There is no
mesh and no shard_map: the port drives one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert


@dataclass(frozen=True)
class TaskSettings:
    """Static per-task step configuration (the fields scoring reads)."""

    head_type: str                  # retrieval
    loss_type: str = "ce"           # ce|bce|mse|rank
    score_agg_func: str = "mean"    # mean|max|lse


def aggregate_clips(logits: torch.Tensor, agg: str) -> torch.Tensor:
    """(B, nc, L) -> (B, L) for mean / max clip pooling."""
    if agg == "mean":
        return logits.mean(dim=1)
    if agg == "max":
        return logits.amax(dim=1)
    raise ValueError(f"aggregate_clips called with {agg}")


def lse_pooled_logits(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time LSE pooling over the clip axis
    (run_video_retrieval.py:668-677)."""
    return torch.logsumexp(logits.float(), dim=1)


def pool_clip_logits(logits: torch.Tensor, agg: str) -> torch.Tensor:
    """Eval pooling for all three agg functions; (B, nc, L) -> (B, L)."""
    if agg == "lse":
        return lse_pooled_logits(logits)
    return aggregate_clips(logits, agg)


def fused_attn_default(device: torch.device) -> bool:
    """The fused attention kernel runs the scoring programs on a CUDA
    device (the JAX package picks its Pallas kernel for one accelerator
    the same way); CPU tensors take the einsum path."""
    return torch.device(device).type == "cuda"


def make_visual_encode_step(compute_dtype=torch.bfloat16) -> Callable:
    """(model, pixels (B, T, H, W, 3)) -> grid features (B, T, Hg, Wg, D)."""

    @torch.inference_mode()
    def step(model: clipbert.ClipBert, pixels: torch.Tensor) -> torch.Tensor:
        return clipbert.cnn_forward(model.cnn, pixels, compute_dtype)

    return step


def make_text_score_step(cfg: ModelConfig, ts: TaskSettings,
                         compute_dtype=torch.bfloat16,
                         fused_attn: Optional[bool] = None) -> Callable:
    """(model, feats (B_v, nc, T, Hg, Wg, D), ids (B_t, Lt), mask) ->
    (B_v, B_t, nc, L) logits: every (video, clip) paired with every text in
    one BERT batch of B_v*nc*B_t sequences. ``fused_attn=None`` takes the
    kernel when the features lie on a CUDA device."""

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        fused = (fused_attn_default(feats.device) if fused_attn is None
                 else fused_attn)
        B_v, nc = feats.shape[:2]
        B_t = ids.shape[0]
        f = feats.reshape((B_v * nc,) + feats.shape[2:])
        f = f.repeat_interleave(B_t, dim=0)
        out = clipbert.clipbert_forward(
            model, cfg,
            {"text_input_ids": ids.repeat(B_v * nc, 1),
             "text_input_mask": mask.repeat(B_v * nc, 1)},
            ts.head_type, compute_dtype=compute_dtype, visual_features=f,
            fused_attn=fused)
        return out["logits"].reshape(B_v, nc, B_t, -1).transpose(1, 2)

    return step


def make_text_prob_step(cfg: ModelConfig, ts: TaskSettings,
                        compute_dtype=torch.bfloat16,
                        fused_attn: Optional[bool] = None) -> Callable:
    """Like make_text_score_step plus clip pooling and softmax/sigmoid:
    (B_v, B_t) fp32 positive-class probabilities
    (run_video_retrieval.py:679-682)."""
    score = make_text_score_step(cfg, ts, compute_dtype, fused_attn)

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        clip_logits = score(model, feats, ids, mask)   # (B_v, B_t, nc, L)
        B_v, B_t = clip_logits.shape[:2]
        pooled = pool_clip_logits(
            clip_logits.reshape((-1,) + clip_logits.shape[2:]),
            ts.score_agg_func).float().reshape(B_v, B_t, -1)
        if ts.loss_type == "ce":
            return torch.softmax(pooled, dim=-1)[..., 1]
        return torch.sigmoid(pooled[..., 0])

    return step
