"""LayerNorm with fp32 statistics (port of clipbert_tpu/ops/layernorm.py),
and the RMSNorm of the deepseek_v3 joint encoder."""

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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis (DeepSeek-V3's DeepseekV3RMSNorm): x /
    sqrt(mean(x^2) + eps) * weight, in fp32, one rounding to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)
