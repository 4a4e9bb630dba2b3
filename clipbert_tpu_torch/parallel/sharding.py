"""Tensor-parallel split of the BERT encoder (port of
clipbert_tpu/parallel/sharding.py).

Megatron's column/row split per layer over the mesh's model axis:

 - q/k/v and the FFN intermediate are split by columns (their outputs):
   each rank keeps a contiguous slice of the output features, bias
   included;
 - ``attention.output.dense`` and ``output.dense`` are split by rows (their
   inputs): each rank keeps the matching slice of the input features and
   the bias stays whole, added once after the all-reduce
   (ops/linear.py::dense_row_parallel).

The CNN, the embeddings, the LayerNorms, the pooler and the head stay
replicated. Each layer then needs exactly the two all-reduces of the
hand-written Megatron schedule, after its two row-parallel products.

The JAX rules name kernel dims of a stacked (layers, in, out) kernel: a
column split is dim 2, a row split dim 1. ``nn.Linear`` keeps its weight as
(out, in), so here a column split is weight dim 0 plus the bias, and a row
split weight dim 1 with the bias whole. Transposing the rule without
flipping the dimension still runs, and gives wrong numbers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clipbert_tpu_torch.core.mesh import Mesh

# (parameter-name suffix, split dim of nn.Linear's (out, in) weight or of
# its (out,) bias); a bias not listed is replicated
_TP_RULES = (
    ("attention.self.query.weight", 0),
    ("attention.self.key.weight", 0),
    ("attention.self.value.weight", 0),
    ("attention.self.query.bias", 0),
    ("attention.self.key.bias", 0),
    ("attention.self.value.bias", 0),
    ("attention.output.dense.weight", 1),   # row-parallel (input dim)
    ("intermediate.dense.weight", 0),
    ("intermediate.dense.bias", 0),
    ("output.dense.weight", 1),             # row-parallel (input dim)
)


def tp_split_dim(name: str) -> Optional[int]:
    """The dimension along which parameter ``name`` (a
    ``model.named_parameters()`` name) is split over the model axis, or
    None when it is replicated."""
    if ".encoder." in f".{name}":
        for suffix, dim in _TP_RULES:
            if name.endswith(suffix):
                return dim
    return None


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut every split encoder parameter down to this rank's contiguous
    shard, in place; returns ``model``. q/k/v rows are head-major (row
    ``h * dh + d``), so rank ``r`` of ``n`` keeps heads ``[r H/n, (r+1)
    H/n)``; the FFN keeps intermediate features ``[r I/n, (r+1) I/n)``. A
    1-wide model axis changes nothing."""
    n, r = mesh.n_model, mesh.model_idx
    if n == 1:
        return model
    for name, p in model.named_parameters():
        dim = tp_split_dim(name)
        if dim is None:
            continue
        size = p.shape[dim]
        if size % n:
            raise ValueError(f"{name}: dim {dim} of size {size} does not "
                             f"split over {n} model ranks")
        w = size // n
        p.data = p.data.narrow(dim, r * w, w).contiguous()
    return model
