"""torch.profiler around a window, reduced to what the per-layer readers
and the result line take: device busy seconds (the union of device
activity), each kernel name's device time and launches, the longest
device operations and the longest idle gaps named by what the host was
doing meanwhile."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

NAME_CHARS = 160     # a kernel's name in the breakdown, cut to this


class Trace:
    """A started and stopped profiler, reduced."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: Dict[str, List[float]] = {}   # name -> [seconds, n]
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.n_device_events = 0

    def kernel_time(self, match: str) -> Tuple[float, int]:
        """(device seconds, launches) of every kernel whose name holds
        ``match``."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if match in name:
                s += sec
                n += cnt
        return s, n

    def launches(self) -> int:
        return sum(int(v[1]) for v in self.kernels.values())


class Tracer:
    """``with Tracer(device) as t:`` ... ``t.trace``; a no-op off a card
    except for the window's length."""

    def __init__(self, device, enabled: bool = True):
        self.device = device
        self.enabled = enabled
        self.trace = Trace()
        self._prof = None
        self._t0 = 0.0

    def __enter__(self) -> "Tracer":
        import torch
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc) -> bool:
        self._sync()
        self.trace.window_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                reduce_profile(self._prof, self.trace)
        return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def reduce_profile(prof, trace: Trace, top: int = 10) -> Trace:
    """Reads the profiler's raw events (``kineto_results``: a fraction of
    the time ``prof.events()`` takes to build its tree on a long
    window)."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        a, b = _span_ns(e)
        if e.device_type() == DeviceType.CUDA:
            dev.append((a, b))
            rec = trace.kernels.setdefault(e.name(), [0.0, 0])
            rec[0] += (b - a) / 1e9
            rec[1] += 1
        elif e.device_type() == DeviceType.CPU:
            host.append((a, b, e.name()))
    trace.n_device_events = len(dev)
    busy = _union(dev)
    trace.busy_s = sum(b - a for a, b in busy) / 1e9
    trace.device_ops = sorted(((k[:NAME_CHARS], v[0])
                               for k, v in trace.kernels.items()),
                              key=lambda r: -r[1])[:top]
    gaps = sorted(((busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    trace.idle_gaps = [(_host_activity(host, a, b), (b - a) / 1e9)
                       for a, b in gaps]
    return trace


def _host_activity(host: List[Tuple[float, float, str]], a: float,
                   b: float) -> str:
    """The host operation that overlaps most of the gap [a, b], the
    shortest of equals; 'host python' where none was recorded."""
    best: Optional[Tuple[float, float, str]] = None
    for s, e, name in host:
        ov = min(e, b) - max(s, a)
        if ov <= 0:
            continue
        key = (ov, -(e - s), name)
        if best is None or key > best:
            best = key
    return f"host {best[2][:NAME_CHARS]}" if best else "host python"
