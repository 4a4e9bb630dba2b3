"""What the measurement tools (bench_train_step, bench_retrieval_eval,
bench_dataplane, train_convergence) share: the card's name, a device
that must be there, and a run that prints one JSON line even when it
fails or is cut.

A :class:`ToolRun` names the stage it is in (progress goes to stderr).
If its body raises, it prints ``{"metric": ..., "value": null,
"failure": ...}`` and lets the error end the process non-zero; if
``deadline_s`` passes first, a watchdog thread prints ``{"metric": ...,
"value": null, "timeout_stage": ...}`` and ends the process with code 124,
whatever the main thread is blocked in (a hung kernel or a stuck loader
cannot be interrupted from Python)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

import torch

TIMEOUT_EXIT = 124
# ends the process from the watchdog thread (os._exit: the main thread may
# be blocked in native code); tests stand in their own
_hard_exit = os._exit


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def device_of(name: str) -> torch.device:
    """``--device``: a CUDA device that is not there is an error, never a
    silent fall back to the CPU (tasks/common.py::device_for)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available "
                           "(pass --device cpu)")
    return device


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device: torch.device, iters: int = 1) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` calls: CUDA events on
    a card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (each counts where its kernel
    launches, and each body's own where it has several), and
    ops/linear.py::dense's CUDA calls: the matmul_bn_act launches among
    them (``dense_kernel``, ``dense_kernel_wg`` on the wg body) and the
    unfused ones (``dense_plain``)."""
    from clipbert_tpu_torch.ops import fused_attention as fa
    from clipbert_tpu_torch.ops import fused_stem_pool as fsp
    from clipbert_tpu_torch.ops import linear as lin
    from clipbert_tpu_torch.ops import matmul_bn_act as mba
    return {"fused_attention": fa.LAUNCHES,
            "fused_attention_tc": fa.TC_LAUNCHES,
            "matmul_bn_act": mba.LAUNCHES,
            "matmul_bn_act_wg": mba.WG_LAUNCHES,
            "fused_stem_pool": fsp.LAUNCHES,
            "fused_stem_pool_tc": fsp.TC_LAUNCHES,
            "fused_attention_shard_heads": fa.SHARD_HEADS_LAUNCHES,
            "dense_kernel": lin.DENSE_KERNEL_CALLS,
            "dense_kernel_wg": lin.DENSE_WG_CALLS,
            "dense_plain": lin.DENSE_PLAIN_CALLS}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


class ToolRun:
    """``with ToolRun(metric, deadline_s) as run:`` ... ``run.at(stage)``,
    ``run.emit(record)``."""

    def __init__(self, metric: str, deadline_s: float = 0.0):
        self.metric = metric
        self.stage = "setup"
        self.deadline_s = deadline_s
        self._lock = threading.Lock()
        self._closed = False
        self._timer: Optional[threading.Timer] = None
        self._cleanups: list = []

    def __enter__(self) -> "ToolRun":
        if self.deadline_s and self.deadline_s > 0:
            self._timer = threading.Timer(self.deadline_s, self._cut)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        if exc is not None:
            self._clean()
            self._close({"failure": f"{exc_type.__name__}: {exc}"})
        with self._lock:
            self._closed = True
        return False

    def on_exit(self, fn) -> None:
        """Run ``fn()`` when the run is cut or fails (to stop the
        processes it started)."""
        self._cleanups.append(fn)

    def _clean(self) -> None:
        for fn in self._cleanups:
            try:
                fn()
            except Exception:         # the line is printed whatever happens
                pass

    def at(self, stage: str) -> None:
        self.stage = stage
        print(f"[{self.metric}] {stage}", file=sys.stderr, flush=True)

    def emit(self, record: dict) -> None:
        """One JSON line on stdout (not after the run was cut)."""
        with self._lock:
            if not self._closed:
                print(json.dumps(record), flush=True)

    def _close(self, why: dict) -> bool:
        with self._lock:
            if self._closed:
                return False
            self._closed = True
            print(json.dumps({"metric": self.metric, "value": None,
                              "stage": self.stage, **why}), flush=True)
            return True

    def _cut(self) -> None:
        if self._close({"timeout_stage": self.stage,
                        "deadline_s": self.deadline_s}):
            self._clean()
            sys.stderr.flush()
            _hard_exit(TIMEOUT_EXIT)
