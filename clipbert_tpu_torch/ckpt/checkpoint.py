# Copied from clipbert_tpu/ckpt/checkpoint.py (every member; load_flat added): JAX-free host code.
"""Checkpoint / resume subsystem (a copy of the JAX package's, which is
numpy-only host code, so the port writes and reads exactly its files).

Covers the reference's three checkpoint roles
(`src/utils/load_save.py`, SURVEY.md §5):

 1. Deployment checkpoints ``model_step_{N}`` — params only, written at every
    validation (:43-68 ModelSaver).
 2. Resume bundle ``restore`` — global_step + params + optimizer state with
    backup rotation via atomic renames and auto-resume on startup
    (:245-312 TrainingRestorer).
 3. Run provenance — args.json + model_config.json + a zip snapshot of the
    code tree (:17-40 save_training_meta).

Plus the shape-mismatch-tolerant partial loader (:71-100
load_state_dict_with_mismatch) and :func:`load_flat`, a deploy ``.npz`` as
the flat dict ckpt/from_jax.py takes.

Format: one ``.npz`` per checkpoint (flat path->array mapping, '/'-joined
pytree paths with integer segments for list indices), in the JAX package's
key scheme: the port's tensors are mapped to it by ckpt/from_jax.py::
to_jax_flat before they are saved. Writes go through a temp file + atomic
rename, so a preempted host never leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# pytree <-> flat dict
# ---------------------------------------------------------------------------

def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """Nested dict/list/tuple pytree -> {'a/b/0/c': array}."""
    out: Dict[str, np.ndarray] = {}

    def rec(node, path: str):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = np.asarray(node)

    rec(tree, "")
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """Inverse of flatten_tree; integer path segments become list indices."""
    root: Dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


# ---------------------------------------------------------------------------
# low-level save / load
# ---------------------------------------------------------------------------

def fetch_tree_host(tree) -> Dict[str, np.ndarray]:
    """Flatten + bring every leaf to host memory (the D2H fetch).

    This is the only part of a save that must stay synchronous with the
    train loop: after it returns, the checkpoint no longer references
    device buffers, so the next jitted step is free to donate them.
    Host-numpy leaves are snapshotted too (np.asarray would alias them,
    and a caller mutating its tree must not corrupt a pending write).
    """
    out = {}
    for k, v in flatten_tree(tree).items():
        a = np.asarray(v)
        out[k] = a.copy() if a is v else a
    return out


def _write_npz(path: str, host_flat: Dict[str, np.ndarray]) -> None:
    """Atomic: write tmp then rename."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **host_flat)
    os.replace(tmp, path)


def save_tree(path: str, tree) -> None:
    """Atomic: write tmp then rename."""
    _write_npz(path, fetch_tree_host(tree))


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------
#
# The reference blocks its train loop for the full state_dict fetch +
# torch.save on every checkpoint (load_save.py:260,291-299). Here only the
# D2H fetch stays on the loop (donation safety, fetch_tree_host); the
# serialization + disk write run on ONE background thread shared by all
# savers — a single thread keeps writes (and the restore-bundle rotation)
# in submission order, so restore.npz/restore_backup.npz can never
# interleave out of order. Write errors are re-raised on the next
# save/drain rather than lost. ThreadPoolExecutor threads are joined at
# interpreter exit, so even an unexpected exit finishes in-flight writes;
# trainers drain explicitly at step-boundary exits (SIGTERM path).

_WRITER = None
_PENDING: List[Any] = []


def _writer():
    global _WRITER
    if _WRITER is None:
        from concurrent.futures import ThreadPoolExecutor
        _WRITER = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
    return _WRITER


def _submit_write(fn, *args) -> None:
    failures = []
    for f in list(_PENDING):         # retire finished writes
        if f.done():
            _PENDING.remove(f)
            exc = f.exception()
            if exc is not None:
                failures.append(exc)
    _PENDING.append(_writer().submit(fn, *args))
    if failures:
        # surface EVERY failed retired write: raise the first, log the rest
        # (a broken deployment checkpoint must never go unreported)
        for extra in failures[1:]:
            from clipbert_tpu_torch.utils.logger import LOGGER
            LOGGER.error(f"additional checkpoint write failure: {extra!r}")
        raise failures[0]


def drain_writes() -> None:
    """Block until every enqueued checkpoint write has hit disk; re-raises
    the first write error (later failures are logged, never dropped)."""
    global _PENDING
    pending, _PENDING = _PENDING, []
    failures = []
    for f in pending:                # wait for ALL before raising
        exc = f.exception()
        if exc is not None:
            failures.append(exc)
    if failures:
        for extra in failures[1:]:
            from clipbert_tpu_torch.utils.logger import LOGGER
            LOGGER.error(f"additional checkpoint write failure: {extra!r}")
        raise failures[0]


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A deploy ``.npz`` -> {'a/b/0/c': array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_tree(path: str):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_tree(flat)


def load_with_mismatch(target_tree, loaded_flat: Dict[str, np.ndarray]
                       ) -> Tuple[Any, Dict[str, List[str]]]:
    """Merge loaded arrays into target where names AND shapes match
    (reference load_state_dict_with_mismatch, load_save.py:71-100).

    Returns (merged_tree, report) with report keys 'missing' (in target,
    not loaded), 'unexpected' (loaded, not in target), 'mismatched'
    (shape differs — kept from target).
    """
    target_flat = flatten_tree(target_tree)
    merged: Dict[str, np.ndarray] = {}
    report = {"missing": [], "unexpected": [], "mismatched": []}
    for k, tv in target_flat.items():
        if k not in loaded_flat:
            report["missing"].append(k)
            merged[k] = tv
        elif tuple(loaded_flat[k].shape) != tuple(tv.shape):
            report["mismatched"].append(k)
            merged[k] = tv
        else:
            merged[k] = np.asarray(loaded_flat[k], dtype=tv.dtype)
    for k in loaded_flat:
        if k not in target_flat:
            report["unexpected"].append(k)
    return unflatten_tree(merged), report


# ---------------------------------------------------------------------------
# deployment checkpoints
# ---------------------------------------------------------------------------

class ModelSaver:
    """Step-addressed param checkpoints (load_save.py:43-68).

    ``async_write=True`` keeps only the D2H fetch on the calling thread and
    writes the npz from the shared background writer (drain_writes() blocks
    until durable)."""

    def __init__(self, output_dir: str, prefix: str = "model_step",
                 async_write: bool = False):
        self.output_dir = output_dir
        self.prefix = prefix
        self.async_write = async_write
        os.makedirs(output_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"{self.prefix}_{step}.npz")

    def save(self, step: int, params) -> str:
        p = self.path(step)
        if self.async_write:
            _submit_write(_write_npz, p, fetch_tree_host(params))
        else:
            save_tree(p, params)
        return p

    def available_steps(self) -> List[int]:
        pat = re.compile(rf"{self.prefix}_(\d+)\.npz$")
        steps = []
        for fn in os.listdir(self.output_dir):
            m = pat.match(fn)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)


# ---------------------------------------------------------------------------
# resume bundles
# ---------------------------------------------------------------------------

class TrainingRestorer:
    """restore.npz + restore_backup.npz rotation with auto-resume
    (load_save.py:245-312). Call `step(global_step, state_tree)` every train
    step; it saves every `save_steps` steps. On construction, `restore()`
    yields (global_step, state_tree) if a bundle exists.
    """

    def __init__(self, output_dir: str, save_steps: int,
                 async_write: bool = False):
        self.save_steps = max(1, int(save_steps))
        self.restore_path = os.path.join(output_dir, "restore.npz")
        self.backup_path = os.path.join(output_dir, "restore_backup.npz")
        self.async_write = async_write
        os.makedirs(output_dir, exist_ok=True)

    @property
    def has_checkpoint(self) -> bool:
        return (os.path.exists(self.restore_path)
                or os.path.exists(self.backup_path))

    def step(self, global_step: int, state_tree) -> bool:
        if global_step % self.save_steps == 0:
            self.save(global_step, state_tree)
            return True
        return False

    def save(self, global_step: int, state_tree) -> None:
        bundle = {"global_step": np.int64(global_step), "state": state_tree}
        if self.async_write:
            # fetch now (donation safety); rotate-then-write later on the
            # single writer thread — one thread keeps successive saves'
            # rotations in order
            host = fetch_tree_host(bundle)
            _submit_write(self._rotate_and_write, host)
        else:
            self._rotate_and_write(fetch_tree_host(bundle))

    def _rotate_and_write(self, host_flat: Dict[str, np.ndarray]) -> None:
        # rotate current -> backup (atomic), then write fresh
        if os.path.exists(self.restore_path):
            os.replace(self.restore_path, self.backup_path)
        _write_npz(self.restore_path, host_flat)

    def restore(self):
        """(global_step, state_tree) or None; falls back to the backup if
        the primary is torn (load_save.py:264-276)."""
        drain_writes()
        for path in (self.restore_path, self.backup_path):
            if not os.path.exists(path):
                continue
            try:
                bundle = load_tree(path)
                return int(bundle["global_step"]), bundle["state"]
            except Exception:
                continue
        return None


# ---------------------------------------------------------------------------
# run provenance
# ---------------------------------------------------------------------------

def save_training_meta(output_dir: str, run_cfg_dict: Dict,
                       model_cfg_dict: Dict,
                       code_dir: Optional[str] = None) -> None:
    """args.json + model_config.json + code.zip snapshot
    (load_save.py:17-40)."""
    log_dir = os.path.join(output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump(run_cfg_dict, f, indent=2, default=str)
    with open(os.path.join(log_dir, "model_config.json"), "w") as f:
        json.dump(model_cfg_dict, f, indent=2)
    if code_dir:
        zpath = os.path.join(output_dir, "code.zip")
        with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
            for dirpath, dirnames, files in os.walk(code_dir):
                dirnames[:] = [d for d in dirnames
                               if d not in (".git", "__pycache__", "output",
                                            ".pytest_cache")]
                for fn in files:
                    if fn.endswith((".py", ".json", ".md", ".cc", ".h",
                                    "Makefile")):
                        full = os.path.join(dirpath, fn)
                        zf.write(full, os.path.relpath(full, code_dir))


def load_training_args(output_dir: str) -> Optional[Dict]:
    p = os.path.join(output_dir, "log", "args.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)
