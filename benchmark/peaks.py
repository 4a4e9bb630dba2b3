"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Dict, Optional

H100_SXM = {"bf16_flops": 989e12, "fp32_flops": 67e12, "int8_ops": 1979e12,
            "bytes": 3.35e12, "power_w": 700.0}


def lookup(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by the name ``torch.cuda.get_device_name``
    gives, or None for a device with no entry (the CPU)."""
    return H100_SXM if "H100" in kind else None
