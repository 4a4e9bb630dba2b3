# Copied from clipbert_tpu/ckpt/checkpoint.py (the read side: ModelSaver.path/available_steps, load_training_args): JAX-free host code.
"""Reading the JAX package's deployment checkpoints and run provenance.

 - Deployment checkpoints ``model_step_{N}.npz`` (reference
   `src/utils/load_save.py:43-68`): one ``.npz`` of the flat parameter tree,
   '/'-joined pytree paths with integer segments for list indices
   (clipbert_tpu/ckpt/checkpoint.py::flatten_tree). :func:`load_flat`
   returns that flat dict, which ckpt/from_jax.py::load_jax_params takes as
   it is.
 - ``log/args.json``, the stored training args that inference replays
   (:func:`load_training_args`).

Writing checkpoints comes with the training slice of the port.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A deploy ``.npz`` -> {'a/b/0/c': array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class ModelSaver:
    """Step-addressed param checkpoints (load_save.py:43-68), read side."""

    def __init__(self, output_dir: str, prefix: str = "model_step"):
        self.output_dir = output_dir
        self.prefix = prefix

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"{self.prefix}_{step}.npz")

    def available_steps(self) -> List[int]:
        pat = re.compile(rf"{self.prefix}_(\d+)\.npz$")
        steps = []
        for fn in os.listdir(self.output_dir):
            m = pat.match(fn)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)


def load_training_args(output_dir: str) -> Optional[Dict]:
    p = os.path.join(output_dir, "log", "args.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
