"""Weight bridge between the JAX package's parameter trees and the port's
modules, both ways.

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
that no leaf fills, raises. :func:`to_jax_flat` runs the rules backwards:
the port's tensors (a model's state, or optimizer moments keyed by the same
names) -> the flat JAX key scheme, with the encoder layers stacked again,
so clipbert_tpu/ckpt/checkpoint.py::load_tree reads what the port writes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

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


def port_values(tree) -> Dict[str, np.ndarray]:
    """A JAX tree (nested or flat, numpy leaves) -> {port state name: fp32
    array in the port's layout}."""
    nested = any(isinstance(v, (dict, list, tuple)) for v in tree.values())
    flat = _flatten(tree) if nested else tree
    values: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        for name, a in _entries(key, np.asarray(arr, np.float32)):
            values[name] = a
    return values


def jax_name(name: str) -> Tuple[str, Optional[int]]:
    """A port state name -> (its JAX leaf path, the encoder layer it is a
    slice of, or None)."""
    parts = name.split(".")
    layer = None
    if tuple(parts[:4]) == (*_ENCODER, "layers"):
        layer = int(parts[4])
        parts = [*_ENCODER, *parts[5:]]
    if parts[-1] == "weight":
        if parts[-2] == "ln":
            parts[-1] = "scale"
        elif parts[-2] in _TABLES:
            parts = parts[:-1]
        else:
            parts[-1] = "kernel"
    return "/".join(parts), layer


def to_jax_flat(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{port state name: tensor} -> the flat JAX tree {'a/b/0/c': fp32
    array} on the host: dense kernels (in, out), conv kernels HWIO, the
    encoder layers stacked on a leading axis."""
    out: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in tensors.items():
        key, layer = jax_name(name)
        t = t.detach().float()
        if key.endswith("/kernel"):
            # the layout change on the tensor's device (a transposing copy
            # there is fast; numpy's on the host is not)
            t = t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)
        # a copy, never a view of the live tensor: an async write must not
        # see the next update
        a = t.contiguous().to("cpu", copy=True).numpy()
        if layer is None:
            out[key] = a
        else:
            layers.setdefault(key, {})[layer] = a
    for key, by_layer in layers.items():
        out[key] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and its buffers that are set (a folded BN
    has no ``scale``), by state name; the tied MLM decoder appears once,
    as the word-embedding table."""
    state = dict(model.named_parameters())
    state.update((n, b) for n, b in model.named_buffers() if b is not None)
    return state


@torch.no_grad()
def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (nested or flat, numpy leaves) into
    ``model`` in place, on the model's device; returns the model."""
    values = port_values(tree)
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
