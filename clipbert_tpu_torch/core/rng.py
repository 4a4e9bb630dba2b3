"""Named dropout randomness for one train step (port of
clipbert_tpu/core/rng.py).

The JAX package folds a stable tag of each name and a per-name counter into
the step key. Here the step has an integer seed, and each named draw gets
its own ``torch.Generator`` seeded from (step seed, crc32(name), counter)
through numpy's SeedSequence: deterministic across processes, independent
of every global RNG, and needing no device synchronization. Code that runs
twice under activation checkpointing takes an integer seed
(:meth:`RngGen.seed`) and builds its generators inside the checkpointed
function, so the recomputation draws the same masks.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np
import torch


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed from ``seed`` and integer ``path`` components."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(path))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: Optional[int],
              device: torch.device | str) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed``; None for None."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class RngGen:
    """Deterministic named generators for one step; every call returns
    None when ``seed`` is None (eval: no dropout)::

        rngs = RngGen(step_seed, device)
        g = rngs("emb_dropout")      # stable per (step seed, name, counter)
    """

    def __init__(self, seed: Optional[int], device: torch.device | str):
        self._seed = seed
        self.device = torch.device(device)
        self._counts: Dict[str, int] = {}

    def seed(self, name: str) -> Optional[int]:
        if self._seed is None:
            return None
        idx = self._counts.get(name, 0)
        self._counts[name] = idx + 1
        tag = zlib.crc32(name.encode()) & 0x7FFFFFFF
        return derive_seed(self._seed, tag, idx)

    def __call__(self, name: str) -> Optional[torch.Generator]:
        return generator(self.seed(name), self.device)
