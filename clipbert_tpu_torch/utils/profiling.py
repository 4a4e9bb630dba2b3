# Copied from clipbert_tpu/utils/profiling.py (StepTimer; TraceWindow on torch.profiler): JAX-free host code.
"""Tracing / profiling hooks (port of clipbert_tpu/utils/profiling.py).

The reference has none (only coarse wall-clock logs around validation).
A per-step wall-clock timer with percentile summaries (StepTimer, copied),
and a ``torch.profiler`` trace over a step window (TraceWindow, in place of
``jax.profiler``), written as a Chrome trace.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np


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
