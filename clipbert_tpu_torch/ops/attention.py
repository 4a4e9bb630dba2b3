"""Multi-head self-attention (port of clipbert_tpu/ops/attention.py).

softmax(QK^T/sqrt(d) + bias)V with an additive mask bias, fp32 softmax, the
reference BertSelfAttention semantics (`src/modeling/transformers.py:
202-286`), with dropout on the attention probabilities in training (the
einsum core only: the fused kernel takes dropout-free calls).

Under a tensor-parallel mesh (parallel/sharding.py) the projections hold
this rank's contiguous block of heads, and the core runs on those heads
only; the output projection that follows is row-parallel
(models/bert.py::encoder).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.ops.dropout import dropout
from clipbert_tpu_torch.ops.fused_attention import (
    fused_attention, fused_attention_shard_heads)
from clipbert_tpu_torch.ops.linear import dense


class SelfAttention(nn.Module):
    """The query/key/value projections (nn.Linear, (out, in) weights)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)


def multi_head_attention(hidden: torch.Tensor, p: SelfAttention,
                         num_heads: int,
                         mask_bias: Optional[torch.Tensor] = None,
                         fused: bool = False,
                         mesh: Optional[Mesh] = None,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """hidden (B, L, D) -> context (B, L, D / n_model) in hidden's dtype,
    where n_model is ``mesh``'s model axis (1 without a mesh).

    One merged (D -> 3 D / n_model) projection of this rank's q/k/v shards
    with the ops.linear recipe; q, k and v are strided views of it, each
    with ``num_heads / n_model`` heads. ``fused`` picks the core as the JAX
    package's strict gate does (clipbert_tpu/ops/attention.py:77-82):
    ``True`` runs the fused kernel (ops/fused_attention.py), through
    fused_attention_shard_heads on the local heads under a tensor-parallel
    ``mesh``, and anything else takes the einsum path, as does a mask that
    is not the standard per-key bias (B, 1, 1, L), or a call with dropout
    (``dropout_rate`` > 0 and a ``generator``: the training path)."""
    B, L, D = hidden.shape
    n_model = mesh.n_model if mesh is not None else 1
    if num_heads % n_model:
        raise ValueError(f"{num_heads} heads do not split over {n_model} "
                         "model ranks")
    head_dim = D // num_heads
    heads = num_heads // n_model
    Dl = heads * head_dim
    if p.query.weight.shape[0] != Dl:
        raise ValueError(f"query projection has {p.query.weight.shape[0]} "
                         f"outputs; {heads} local heads need {Dl}")
    w = torch.cat([p.query.weight, p.key.weight, p.value.weight])
    b = torch.cat([p.query.bias, p.key.bias, p.value.bias])
    qkv = dense(hidden, w, b)                              # (B, L, 3 Dl)
    q, k, v = (t.view(B, L, heads, head_dim)
               for t in qkv.split(Dl, dim=-1))

    use_fused = (fused is True
                 and (dropout_rate == 0.0 or generator is None)
                 and mask_bias is not None
                 and tuple(mask_bias.shape) == (B, 1, 1, L))
    if use_fused:
        scale = 1.0 / head_dim ** 0.5
        key_bias = mask_bias[:, 0, 0, :]
        if n_model > 1:
            ctx = fused_attention_shard_heads(q, k, v, key_bias, scale,
                                              mesh, num_heads)
        else:
            ctx = fused_attention(q, k, v, key_bias, scale)
        return ctx.reshape(B, L, Dl)

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if mask_bias is not None:
        scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, dropout_rate, generator)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(hidden.dtype).float(),
                       v.float()).to(hidden.dtype)
    return ctx.reshape(B, L, Dl)
