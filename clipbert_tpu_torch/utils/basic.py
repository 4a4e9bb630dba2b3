# Copied from clipbert_tpu/utils/basic.py (load_json, save_json, load_jsonl, flat_list_of_lists): JAX-free host code.
"""Small io helpers (reference `src/utils/basic_utils.py`)."""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: str, indent: int = 2) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, default=str)


def load_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def flat_list_of_lists(lst: Iterable[Iterable]) -> List:
    return [x for sub in lst for x in sub]
