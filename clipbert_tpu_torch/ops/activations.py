"""Activation functions (port of clipbert_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, as HF ``gelu`` in BERT."""
    return F.gelu(x, approximate="none")


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (HF ``gelu_new``)."""
    return F.gelu(x, approximate="tanh")


ACT2FN = {
    "gelu": gelu,
    "relu": torch.relu,
    "gelu_new": gelu_new,
}
