# Copied from clipbert_tpu/utils/profiling.py (StepTimer; TraceWindow on torch.profiler): JAX-free host code.
"""Tracing / profiling hooks (port of clipbert_tpu/utils/profiling.py).

The reference has none (only coarse wall-clock logs around validation).
A per-step wall-clock timer with percentile summaries (StepTimer, copied),
a ``torch.profiler`` trace over a step window (TraceWindow, in place of
``jax.profiler``), written as a Chrome trace, and the port's one span
facility (``span``, ``collect``, ``totals``).

A span names a stretch of one thread's work at a loop boundary::

    with profiling.span("vqa.data_wait"):
        batch = next(it, None)

Unless a ``torch.profiler`` is recording or a ``collect()`` scope is open
it is off: a shared no-op that reads two flags, no clock, and records
nothing. While a profiler records, each span is also a record-function
range of its name on the profiler's timeline (the profiler's Chrome trace
is the export) and is summed into ``totals()``; inside ``collect()`` the
scope gets every span closed while it was open, from every thread. A
span's times are stamped inside its range on the clock the profiler's
CPU events carry (``time.time_ns``: the profiler converts its own clock
to the Unix epoch), so the two agree.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch.autograd.profiler as _torch_profiler
# record_function's fast form: a range of a few us, recorded as a host op.
# record_function itself is a user annotation, which the profiler also
# draws on the GPU timeline over the kernels launched inside it, where a
# trace's device-busy union would count it as device work.
from torch._C._profiler import _RecordFunctionFast as _Range


class StepTimer:
    """Per-step wall-clock meter; cheap enough to run always."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0   # already stopped since the last start (the trainer
                         # consumes two pendings on sync-point iterations)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.array(self._times)
        return {"step_time_mean_s": float(arr.mean()),
                "step_time_p50_s": float(np.percentile(arr, 50)),
                "step_time_p95_s": float(np.percentile(arr, 95)),
                "steps_per_sec": float(1.0 / arr.mean())}


class TraceWindow:
    """Capture a torch.profiler trace (CPU, and CUDA where available) for
    steps [start, stop) into ``log_dir/trace_steps_<start>-<stop>.json``."""

    def __init__(self, log_dir: Optional[str], start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.log_dir and self._prof is None and step == self.start_step:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def maybe_stop(self, step: int):
        """Close the window once ``step`` reaches its end; returns the
        stopped profiler then (its events stay readable), else None."""
        if self._prof is not None and step >= self.stop_step:
            return self.close()
        return None

    def close(self):
        """Stop the profiler and write its trace; returns the profiler, or
        None when none ran."""
        if self._prof is not None:
            import os
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.log_dir,
                f"trace_steps_{self.start_step}-{self.stop_step}.json"))
            return prof
        return None


# -- spans ------------------------------------------------------------------

_CLOCK = time.time_ns
_LOCK = threading.Lock()     # guards _TOTALS, _COLLECTORS and their sums
_TLS = threading.local()     # .stack: the open spans of this thread
_COLLECTORS: List["collect"] = []
_collecting = False          # any collect() open
# name -> [ns, count, self ns] of the spans begun while a profiler recorded
_TOTALS: Dict[str, List[int]] = {}


class Span:
    """One span: its name, start and end (ns, the profiler's clock), its
    parent (the span open around it on its thread, or None) and the ns its
    children took."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "child_ns",
                 "profiled", "_rf")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled
        self.child_ns = 0
        self.end_ns = 0
        self._rf = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if self.profiled:
            self._rf = _Range(self.name)
            self._rf.__enter__()
        self.start_ns = _CLOCK()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _CLOCK()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _TLS.stack.pop()
        ns = self.end_ns - self.start_ns
        if self.parent is not None:
            self.parent.child_ns += ns
        with _LOCK:
            if self.profiled:
                _add(_TOTALS, self)
            for c in _COLLECTORS:
                _add(c.acc, self)
        return False


class _Off:
    """The span of a process that collects none: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A context manager timing the block as span ``name`` where a
    profiler records or a ``collect()`` is open; else a shared no-op that
    reads no clock and allocates nothing."""
    profiled = _torch_profiler._is_profiler_enabled
    if not (profiled or _collecting):
        return _OFF
    return Span(name, profiled)


def collecting() -> bool:
    """Whether a ``collect()`` scope is open (in any thread): where a layer
    keeps a device-side tally only while one is (ops/moe.py's per-expert
    row counts)."""
    return _collecting


def _add(acc: Dict[str, List[int]], s: Span) -> None:
    a = acc.get(s.name)
    if a is None:
        a = acc[s.name] = [0, 0, 0]
    a[0] += s.ns
    a[1] += 1
    a[2] += s.ns - s.child_ns


def _as_seconds(acc: Dict[str, List[int]]) -> Dict[str, Dict[str, float]]:
    return {k: {"s": v[0] / 1e9, "n": v[1], "self_s": v[2] / 1e9}
            for k, v in acc.items()}


def totals() -> Dict[str, Dict[str, float]]:
    """{span name: {"s": seconds, "n": count, "self_s": seconds less its
    children's}} over every span begun while a profiler recorded, since
    the process started (in the benchmark's traced run: its window)."""
    with _LOCK:
        return _as_seconds(_TOTALS)


class collect:
    """``with collect() as c:`` ... ``c.totals()``: ``totals()``'s
    aggregates over the spans of every thread closed while the scope was
    open, with or without a profiler."""

    def __init__(self):
        self.acc: Dict[str, List[int]] = {}

    def __enter__(self) -> "collect":
        global _collecting
        with _LOCK:
            _COLLECTORS.append(self)
            _collecting = True
        return self

    def __exit__(self, *exc) -> bool:
        global _collecting
        with _LOCK:
            _COLLECTORS.remove(self)
            _collecting = bool(_COLLECTORS)
        return False

    def totals(self) -> Dict[str, Dict[str, float]]:
        with _LOCK:
            return _as_seconds(self.acc)
