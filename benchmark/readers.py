"""Arithmetic the per-layer readers in ``benchmark/metrics/`` share. Each
reader returns None where its run gives it nothing to read (no trace, no
peak for the device, no launch of its kernel), never 0 for a share."""

from __future__ import annotations

import sys
from typing import Dict, Optional

from benchmark import peaks


def mfu(run: Dict) -> Optional[float]:
    """The window's analytic model FLOPs over its time, as a share (%) of
    the card's bf16 peak."""
    flops = run.get("work", {}).get("model_flops")
    peak = peaks.lookup(run["device"]["kind"])
    if not flops or peak is None or run["window_s"] <= 0:
        return None
    return 100.0 * flops / run["window_s"] / peak["bf16_flops"]


def idle_share(run: Dict) -> Optional[float]:
    """The share (%) of the traced window in which no device operation
    ran."""
    t = run.get("trace")
    if t is None or t.window_s <= 0 or t.n_device_events == 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def kernel_roofline(run: Dict, kernel: str) -> Optional[float]:
    """Sum over the traced launches of the least time the card could take
    (the larger of operations over the peak rate and bytes over the peak
    bandwidth), over the kernel's device time in the trace, as a share
    (%). None where the kernel did not run, or where the launches the port
    recorded and those the trace saw disagree."""
    t = run.get("trace")
    shapes = run.get("launch_shapes", {}).get(kernel)
    mod = run.get("rooflines", {}).get(kernel)
    peak = peaks.lookup(run["device"]["kind"])
    if t is None or not shapes or mod is None or peak is None:
        return None
    seconds, launches = t.kernel_time(mod.TRACE_MATCH)
    if launches != len(shapes) or seconds <= 0:
        print(f"{kernel}: {len(shapes)} launches recorded, {launches} "
              f"in the trace; no roofline", file=sys.stderr, flush=True)
        return None
    bound = 0.0
    for shape in shapes:
        ops, nbytes = mod.work(shape)
        bound += max(ops / peak["bf16_flops"], nbytes / peak["bytes"])
    return 100.0 * bound / seconds
