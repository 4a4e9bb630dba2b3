"""Multi-head self-attention (port of clipbert_tpu/ops/attention.py).

softmax(QK^T/sqrt(d) + bias)V with an additive mask bias, fp32 softmax, the
reference BertSelfAttention semantics (`src/modeling/transformers.py:
202-286`). Attention-probability dropout is train-time only and not part
of this inference port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from clipbert_tpu_torch.ops.fused_attention import fused_attention
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
                         fused: bool = False) -> torch.Tensor:
    """hidden (B, L, D) -> context (B, L, D) in hidden's dtype.

    One merged (D -> 3D) projection with the ops.linear recipe; q, k and v
    are strided views of it. ``fused=True`` routes the core through the
    fused kernel (ops/fused_attention.py) when the mask is the standard
    per-key bias (B, 1, 1, L); anything else takes the einsum path."""
    B, L, D = hidden.shape
    head_dim = D // num_heads
    w = torch.cat([p.query.weight, p.key.weight, p.value.weight])
    b = torch.cat([p.query.bias, p.key.bias, p.value.bias])
    qkv = dense(hidden, w, b)                                  # (B, L, 3D)
    q, k, v = (t.view(B, L, num_heads, head_dim)
               for t in qkv.split(D, dim=-1))

    use_fused = (fused is True and mask_bias is not None
                 and tuple(mask_bias.shape) == (B, 1, 1, L))
    if use_fused:
        ctx = fused_attention(q, k, v, mask_bias[:, 0, 0, :],
                              1.0 / head_dim ** 0.5)
        return ctx.reshape(B, L, D)

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if mask_bias is not None:
        scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(hidden.dtype).float(),
                       v.float()).to(hidden.dtype)
    return ctx.reshape(B, L, D)
