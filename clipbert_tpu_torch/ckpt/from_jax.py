"""Weight bridge: the JAX package's parameters -> the port's modules.

Accepts either form the JAX package produces, as numpy:
 - the nested tree, ``jax.tree.map(np.asarray, params)``;
 - the flat ``{"a/b/0/c": array}`` dict of a deploy ``.npz``
   (clipbert_tpu/ckpt/checkpoint.py::flatten_tree).

The port's module tree mirrors the JAX tree by name, so each leaf maps by
a few layout rules:
 - dense ``kernel`` (in, out) -> ``weight`` (out, in) of an ``nn.Linear``;
 - conv ``kernel`` HWIO -> ``weight`` OIHW;
 - LayerNorm ``ln/scale`` -> ``ln.weight``; embedding tables -> ``.weight``;
 - the stacked encoder leaves (L, ...) -> ``encoder.layers.{i}``;
 - frozen BN ``bn/{scale, bias}`` -> the FrozenBN buffers. A folded JAX
   tree (clipbert_tpu/models/resnet.py::fold_bn_scales) has no ``scale``;
   the matching port BN is then folded too (``scale`` None);
 - the heads keep their leaf names: ``classifier/{fc1, fc2}``,
   ``regressor/{fc1, fc2}`` and ``regressor/bn/{scale, bias, mean, var}``
   (parameters and running-statistics buffers of the same names), and
   ``cls/predictions/{transform/..., bias}`` and
   ``cls/seq_relationship``. The MLM decoder is the word-embedding table
   itself (models/clipbert.py::Transformer.mlm_decoder_weight): it has no
   leaf of its own.

The JAX tree's stem already takes RGB: the reference checkpoints' BGR flip
happens when the JAX package imports them (clipbert_tpu/ckpt/
torch_import.py:212). This bridge flips nothing.

Loading is strict: a JAX leaf with no port counterpart, or a port tensor
that no leaf fills, raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from clipbert_tpu_torch.models.resnet import FrozenBN

_TABLES = ("word_embeddings", "position_embeddings", "token_type_embeddings",
           "row_position_embeddings", "col_position_embeddings")
_ENCODER = ("transformer", "bert", "encoder")


def _flatten(node, path: str = "") -> Dict[str, np.ndarray]:
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {path: node}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{path}/{k}" if path else str(k)))
    return out


def _leaf(parts, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """JAX path segments + array -> (port state name, array in its layout)."""
    parts = list(parts)
    last = parts[-1]
    if last == "kernel":
        parts[-1] = "weight"
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    elif last == "scale" and parts[-2] == "ln":
        parts[-1] = "weight"
    elif last in _TABLES:
        parts.append("weight")
    return ".".join(parts), arr


def _entries(key: str, arr: np.ndarray) -> Iterator[Tuple[str, np.ndarray]]:
    parts = key.split("/")
    if tuple(parts[:3]) == _ENCODER:
        for i in range(arr.shape[0]):
            yield _leaf([*_ENCODER, "layers", str(i), *parts[3:]], arr[i])
    else:
        yield _leaf(parts, arr)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (nested or flat, numpy leaves) into
    ``model`` in place, on the model's device; returns the model."""
    nested = any(isinstance(v, (dict, list, tuple)) for v in tree.values())
    flat = _flatten(tree) if nested else tree
    values: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        for name, a in _entries(key, np.asarray(arr, np.float32)):
            values[name] = a
    for mname, m in model.named_modules():
        if isinstance(m, FrozenBN):
            if f"{mname}.scale" not in values:
                m.scale = None
            elif m.scale is None:
                m.scale = torch.empty_like(m.bias)
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    unknown = sorted(values.keys() - state.keys())
    missing = sorted(state.keys() - values.keys())
    if unknown or missing:
        raise KeyError(f"JAX tree does not match the port: leaves with no "
                       f"port tensor {unknown[:8]}, port tensors with no "
                       f"leaf {missing[:8]}")
    for name, t in state.items():
        a = values[name]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: the JAX leaf maps to shape "
                             f"{tuple(a.shape)}, the port tensor is "
                             f"{tuple(t.shape)}")
        t.copy_(torch.tensor(a))
    return model
