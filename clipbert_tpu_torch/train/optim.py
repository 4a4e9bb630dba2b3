"""AdamW with the reference's 8 parameter groups (port of
clipbert_tpu/train/optim.py).

Reference behaviour matched, as the JAX package matches it:
 - HF-style AdamW with decoupled weight decay and bias correction
   (`src/optimization/adamw.py:60-101`, eps 1e-6), and torch's Adam and
   Adamax (L2 in the gradient; the infinity-norm moment);
 - setup_e2e_optimizer's name-based split into 8 groups
   (`src/optimization/utils.py:96-161`): {transformer, cnn} x {lr_mul
   prefix "top", rest} x {decay, no_decay}, no_decay being biases and
   LayerNorm parameters; the transformer groups take ``learning_rate``,
   the cnn groups ``cnn_learning_rate``, the prefix groups lr * lr_mul;
 - frozen BN never trains (here its pairs are buffers, not parameters);
   ``freeze_cnn`` stops the whole CNN.

The groups are keyed by the port's parameter names, each read under its
JAX leaf path (ckpt/from_jax.py::jax_name), so the name rules are the JAX
package's. The update is the JAX per-leaf arithmetic in fp32, in place on
the parameters: each scalar (lr, lr x wd, the bias correction) is an fp32
value computed on the host as the JAX update computes it, and each
elementwise step is one torch op in the JAX expression's order. The tied
MLM decoder is the word-embedding Parameter: it is one leaf, in the
embedding's group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from clipbert_tpu_torch.ckpt.from_jax import jax_name

f32 = np.float32


class GroupMeta(NamedTuple):
    """Per-parameter optimizer metadata."""
    use_cnn_lr: bool
    lr_mul: float
    weight_decay: float
    trainable: bool
    group_id: int  # 0..7 (the reference's 8 groups) or -1 for frozen


@dataclass(frozen=True)
class OptimConfig:
    optim: str = "adamw"  # adamw | adam | adamax (utils.py:118-127)
    learning_rate: float = 5e-5
    cnn_learning_rate: float = 5e-5
    weight_decay: float = 1e-3
    cnn_weight_decay: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-6
    correct_bias: bool = True
    grad_norm: float = 2.0  # -1 disables clipping
    transformer_lr_mul: float = 1.0
    transformer_lr_mul_prefix: str = ""
    cnn_lr_mul: float = 1.0
    cnn_lr_mul_prefix: str = "grid_encoder"
    freeze_cnn: bool = False


def _is_no_decay(name: str) -> bool:
    # reference no_decay = ['bias', 'LayerNorm.bias', 'LayerNorm.weight'];
    # LayerNorm parameters live under .../ln/{scale,bias}
    leaf = name.rsplit("/", 1)[-1]
    return leaf == "bias" or "/ln/" in name or name.endswith("/ln")


def _is_frozen_leaf(name: str, cfg: OptimConfig) -> bool:
    if "cnn/" in name or name.startswith("cnn"):
        if cfg.freeze_cnn:
            return True
        if "/bn/" in name:  # FrozenBatchNorm (scale, bias) pairs
            return True
    # regression-head BatchNorm1d running stats are state, not weights
    if "regressor/bn/mean" in name or "regressor/bn/var" in name:
        return True
    return False


def leaf_meta(name: str, cfg: OptimConfig) -> GroupMeta:
    """The GroupMeta of the JAX leaf path ``name``. Group ids follow the
    reference order: transformer [top_decay, top_nodecay, decay, nodecay]
    then cnn [same] (utils.py:115-117, 146-160)."""
    is_cnn = name.startswith("cnn")
    if _is_frozen_leaf(name, cfg):
        return GroupMeta(is_cnn, 0.0, 0.0, False, -1)
    prefix = cfg.cnn_lr_mul_prefix if is_cnn else cfg.transformer_lr_mul_prefix
    lr_mul = cfg.cnn_lr_mul if is_cnn else cfg.transformer_lr_mul
    is_top = bool(prefix) and prefix in name
    no_decay = _is_no_decay(name)
    wd = 0.0 if no_decay else (cfg.cnn_weight_decay if is_cnn
                               else cfg.weight_decay)
    gid = (4 if is_cnn else 0) + (0 if is_top else 2) + (1 if no_decay else 0)
    return GroupMeta(is_cnn, lr_mul if is_top else 1.0, wd, True, gid)


def build_group_meta(model: torch.nn.Module,
                     cfg: OptimConfig) -> Dict[str, GroupMeta]:
    """{parameter name: GroupMeta} over the model's parameters (buffers
    never train)."""
    return {n: leaf_meta(jax_name(n)[0], cfg)
            for n, _ in model.named_parameters()}


def param_groups(model: torch.nn.Module,
                 meta: Dict[str, GroupMeta]) -> Dict[int, list]:
    """{group id: [parameter names]}, the reference's torch param groups
    (frozen parameters under -1)."""
    groups: Dict[int, list] = {}
    for n, _ in model.named_parameters():
        groups.setdefault(meta[n].group_id, []).append(n)
    return groups


def count_groups(meta: Dict[str, GroupMeta]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for gm in meta.values():
        counts[gm.group_id] = counts.get(gm.group_id, 0) + 1
    return counts


@dataclass
class AdamWState:
    """The update count and the fp32 moments of every trainable parameter,
    by name."""
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init_adamw_state(model: torch.nn.Module,
                     meta: Dict[str, GroupMeta]) -> AdamWState:
    params = {n: p for n, p in model.named_parameters()
              if meta[n].trainable}
    return AdamWState(
        0, {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()},
        {n: torch.zeros_like(p, dtype=torch.float32)
         for n, p in params.items()})


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads]).sum())


def split_global_norm(grads: Dict[str, torch.Tensor], split) -> torch.Tensor:
    """The global norm of a tensor-parallel model's gradients: ``split`` is
    (names of the leaves cut over the model axis, the model group). The
    split leaves' squares are summed over the group; each replicated leaf
    (every model rank holds the same one) counts once."""
    names, group = split
    device = next(iter(grads.values())).device
    sq = [torch.stack([torch.zeros((), device=device)] + [
              torch.sum(torch.square(g.float()))
              for n, g in grads.items() if (n in names) == part]).sum()
          for part in (True, False)]
    torch.distributed.all_reduce(sq[0], group=group)
    return torch.sqrt(sq[0] + sq[1])


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        split=None):
    """torch.nn.utils.clip_grad_norm_ semantics: scale by max_norm / (norm
    + 1e-6) when the norm exceeds max_norm. Returns (clipped, norm).
    ``split`` as in :func:`split_global_norm`."""
    norm = (global_norm(grads.values()) if split is None
            else split_global_norm(grads, split))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * coef.to(g.dtype) for n, g in grads.items()}, norm


def _bias_corr(cfg: OptimConfig, step: int):
    """(bias correction, t) as fp32, the JAX update's ``_bias_corr``."""
    b1, b2 = cfg.betas
    t = f32(step)
    if cfg.correct_bias:
        return f32(np.sqrt(f32(1.0) - f32(b2) ** t)
                   / (f32(1.0) - f32(b1) ** t)), t
    return f32(1.0), t


@torch.no_grad()
def _elementwise_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        v: torch.Tensor, lr, wd: float, cfg: OptimConfig,
                        bias_corr, t) -> None:
    """One parameter's update, in place on the fp32 ``p``, ``m`` and
    ``v``: clip_by_global_norm's output ``g`` in, the expressions of
    clipbert_tpu/train/optim.py::_elementwise_update in their order."""
    b1, b2 = cfg.betas
    if cfg.optim in ("adam", "adamax") and wd > 0:
        g = g + wd * p                  # torch Adam / Adamax: L2 in g
    m.mul_(b1).add_((1.0 - b1) * g)
    if cfg.optim == "adamax":
        torch.maximum(v.mul_(b2), g.abs(), out=v)
        p.sub_(float(f32(lr) / (f32(1.0) - f32(b1) ** t))
               * (m / (v + cfg.eps)))
        return
    v.mul_(b2).add_((1.0 - b2) * torch.square(g))
    p.sub_(float(lr) * (m / (torch.sqrt(v) + cfg.eps) * float(bias_corr)))
    if cfg.optim == "adamw" and wd > 0:
        p.sub_(float(f32(lr) * f32(wd)) * p)


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 meta: Dict[str, GroupMeta], cfg: OptimConfig,
                 lr_transformer, lr_cnn, split=None) -> torch.Tensor:
    """One optimizer step over the trainable parameters, in place (their
    data, ``state``'s moments and its count); returns the global gradient
    norm before clipping, over the trainable parameters only (the
    reference clips its 8 groups; frozen parameters have no gradient).
    ``lr_transformer`` / ``lr_cnn`` are the schedules' fp32 values; a
    parameter's lr is base * lr_mul by its group. Under tensor
    parallelism ``split`` is (the names of the leaves cut over the model
    axis, the model group): the norm is the whole model's
    (:func:`split_global_norm`), and each rank updates its shards."""
    if cfg.optim not in ("adamw", "adam", "adamax"):
        raise ValueError(f"unknown optim {cfg.optim}")
    names = [n for n in params if meta[n].trainable]
    grads = {n: grads[n].float() for n in names}
    if not names:
        state.step += 1
        return torch.zeros(())
    if cfg.grad_norm is not None and cfg.grad_norm > 0:
        grads, norm = clip_by_global_norm(grads, cfg.grad_norm, split)
    elif split is not None:
        norm = split_global_norm(grads, split)
    else:
        norm = global_norm(grads.values())
    state.step += 1
    bias_corr, t = _bias_corr(cfg, state.step)
    for n in names:
        gm = meta[n]
        lr = f32(lr_cnn if gm.use_cnn_lr else lr_transformer) * f32(gm.lr_mul)
        _elementwise_update(params[n].data, grads[n], state.mu[n],
                            state.nu[n], lr, gm.weight_decay, cfg,
                            bias_corr, t)
    return norm
