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
elementwise step is one torch op in the JAX expression's order, run once
per optimizer group as a ``torch._foreach_*`` op over the group's leaves
(the JAX package's group-fused update), or per leaf under tensor
parallelism. The tied MLM decoder is the word-embedding Parameter: it is
one leaf, in the embedding's group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

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


class _Ops(NamedTuple):
    """The elementwise ops of an update: on one leaf (the per-leaf form) or
    on a list of leaves as one ``torch._foreach_*`` call each (the group-
    fused form). Each product is its own op (no ``alpha=``, addcmul,
    addcdiv or lerp, which may contract into an FMA), so both forms round
    every element alike."""
    add: Callable
    mul: Callable
    div: Callable
    sqrt: Callable
    abs: Callable
    add_: Callable
    mul_: Callable
    sub_: Callable
    maximum_: Callable


_LEAF = _Ops(torch.add, torch.mul, torch.div, torch.sqrt, torch.abs,
             torch.Tensor.add_, torch.Tensor.mul_, torch.Tensor.sub_,
             lambda a, b: torch.maximum(a, b, out=a))
_FOREACH = _Ops(torch._foreach_add, torch._foreach_mul, torch._foreach_div,
                torch._foreach_sqrt, torch._foreach_abs, torch._foreach_add_,
                torch._foreach_mul_, torch._foreach_sub_,
                torch._foreach_maximum_)


@torch.no_grad()
def _elementwise_update(o: _Ops, p, g, m, v, lr, wd: float,
                        cfg: OptimConfig, bias_corr, t) -> None:
    """One leaf's update, or one group's through ``o = _FOREACH``, in place
    on the fp32 ``p``, ``m`` and ``v``: clip_by_global_norm's output ``g``
    in, the expressions of clipbert_tpu/train/optim.py::_elementwise_update
    in their order."""
    b1, b2 = cfg.betas
    if cfg.optim in ("adam", "adamax") and wd > 0:
        g = o.add(g, o.mul(p, wd))      # torch Adam / Adamax: L2 in g
    o.mul_(m, b1)
    o.add_(m, o.mul(g, 1.0 - b1))
    o.mul_(v, b2)
    if cfg.optim == "adamax":
        o.maximum_(v, o.abs(g))
        step = o.div(m, o.add(v, cfg.eps))
        o.mul_(step, float(f32(lr) / (f32(1.0) - f32(b1) ** t)))
        o.sub_(p, step)
        return
    sq = o.mul(g, g)
    o.mul_(sq, 1.0 - b2)
    o.add_(v, sq)
    del sq
    den = o.sqrt(v)
    o.add_(den, cfg.eps)
    step = o.div(m, den)
    del den
    o.mul_(step, float(bias_corr))
    o.mul_(step, float(lr))
    o.sub_(p, step)
    del step
    if cfg.optim == "adamw" and wd > 0:
        o.sub_(p, o.mul(p, float(f32(lr) * f32(wd))))


def _trainable(params, meta, cfg: OptimConfig):
    if cfg.optim not in ("adamw", "adam", "adamax"):
        raise ValueError(f"unknown optim {cfg.optim}")
    return [n for n in params if meta[n].trainable]


def _lr(gm: GroupMeta, lr_transformer, lr_cnn):
    return f32(lr_cnn if gm.use_cnn_lr else lr_transformer) * f32(gm.lr_mul)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 meta: Dict[str, GroupMeta], cfg: OptimConfig,
                 lr_transformer, lr_cnn, split=None) -> torch.Tensor:
    """One optimizer step over the trainable parameters, in place (their
    data, ``state``'s moments and its count); returns the global gradient
    norm before clipping, over the trainable parameters only (the
    reference clips its 8 groups; frozen parameters have no gradient).
    ``lr_transformer`` / ``lr_cnn`` are the schedules' fp32 values; a
    parameter's lr is base * lr_mul by its group.

    The group-fused form (clipbert_tpu/train/optim.py::_adamw_update_fused):
    each op of :func:`_elementwise_update` runs once per optimizer group
    over the group's lists of parameters, gradients and moments, so every
    element rounds as in :func:`adamw_update_per_leaf`: bit-equal to it
    without clipping. The norm sums each group's squares over its
    concatenated gradients, another order than :func:`global_norm`'s; the
    clipped gradients are the per-leaf ``g * coef``. The moments stay per
    leaf (the state and the restore bundle keep their schema), and the
    caller's gradients are not written. Under tensor parallelism ``split``
    is (the names of the leaves cut over the model axis, the model group)
    and the step takes the per-leaf form, as the JAX step does."""
    if split is not None:
        return adamw_update_per_leaf(params, grads, state, meta, cfg,
                                     lr_transformer, lr_cnn, split)
    names = _trainable(params, meta, cfg)
    if not names:
        state.step += 1
        return torch.zeros(())
    gs = {n: grads[n].float() for n in names}
    groups: Dict[int, list] = {}
    for n in names:
        groups.setdefault(meta[n].group_id, []).append(n)
    # one sum of squares a group over its concatenated gradients, as the
    # JAX form sums its group vectors (_foreach_norm accumulates a whole
    # leaf serially on the CPU: 3e-5 off at 2M elements)
    norm = torch.sqrt(torch.stack([torch.sum(torch.square(torch.cat(
        [gs[n].reshape(-1) for n in members])))
        for members in groups.values()]).sum())
    if cfg.grad_norm is not None and cfg.grad_norm > 0:
        coef = torch.clamp(cfg.grad_norm / (norm + 1e-6), max=1.0)
        gs = dict(zip(names, torch._foreach_mul([gs[n] for n in names],
                                                coef)))
    state.step += 1
    bias_corr, t = _bias_corr(cfg, state.step)
    for members in groups.values():
        gm = meta[members[0]]
        _elementwise_update(
            _FOREACH, [params[n].data for n in members],
            [gs[n] for n in members], [state.mu[n] for n in members],
            [state.nu[n] for n in members],
            _lr(gm, lr_transformer, lr_cnn), gm.weight_decay, cfg,
            bias_corr, t)
    return norm


@torch.no_grad()
def adamw_update_per_leaf(params: Dict[str, torch.Tensor],
                          grads: Dict[str, torch.Tensor], state: AdamWState,
                          meta: Dict[str, GroupMeta], cfg: OptimConfig,
                          lr_transformer, lr_cnn, split=None) -> torch.Tensor:
    """:func:`adamw_update` one leaf at a time: the reference form, and the
    tensor-parallel one, where ``split`` makes the norm the whole model's
    (:func:`split_global_norm`) and each rank updates its shards."""
    names = _trainable(params, meta, cfg)
    if not names:
        state.step += 1
        return torch.zeros(())
    grads = {n: grads[n].float() for n in names}
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
        _elementwise_update(_LEAF, params[n].data, grads[n], state.mu[n],
                            state.nu[n], _lr(gm, lr_transformer, lr_cnn),
                            gm.weight_decay, cfg, bias_corr, t)
    return norm
