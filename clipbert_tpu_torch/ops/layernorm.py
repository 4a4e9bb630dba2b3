"""LayerNorm with fp32 statistics (port of clipbert_tpu/ops/layernorm.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Normalize over the last axis in fp32; returns x's dtype (bf16 in ->
    bf16 out). ``eps`` comes from ``ModelConfig.layer_norm_eps``."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)
