"""Dropout with an explicit generator (port of clipbert_tpu/ops/dropout.py).

The JAX function takes an explicit PRNG key; here the randomness comes from
an explicit ``torch.Generator`` on the tensor's device, so a train step is
reproducible from its seed and touches no global RNG state. The masks are
not JAX's ``bernoulli`` bits: the same rate and scaling, other draws.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1 / (1 - rate)``; no generator, or a rate of 0, is the identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
