# Copied from clipbert_tpu/utils/basic.py (load_jsonl, save_json): JAX-free host code.
"""Small io helpers (reference `src/utils/basic_utils.py`)."""

from __future__ import annotations

import json
from typing import Any, Dict, List


def save_json(obj: Any, path: str, indent: int = 2) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, default=str)


def load_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]
