"""One run of one cell: find the cell's files by name, set it up, time the
window, read the per-layer metrics, check the outputs against the plain
reference, print one JSON line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel sits in a file of its own that this module finds by the
name ``BENCHMARK.json`` gives:

    benchmark/configs/<config>.json     (the ``file`` of the configuration)
    benchmark/traffic/<traffic>.json    names its ``driver``
    benchmark/drivers/<driver>.py       setup / window / release / check
    benchmark/limits/<cell>.json        the limit of each number compared
    benchmark/metrics/<metric>.py       read(run) -> value or None
    benchmark/rooflines/<kernel>.py     a kernel's operations and bytes

A driver module has four functions. ``setup(ctx)`` builds the program's
state from ``ctx.seed`` (counted in ``setup_s``); ``window(state, ctx)``
runs the timed work for ``ctx.seconds`` and returns ``{"e2e": {metric:
value}, "work": {...}, "stats": {...}, "attempted": n, "failed": n}``;
``release(state)`` frees the program, keeping what the check needs;
``check(state, ctx)`` returns ``{name: number}``, each held to
``ctx.limits[name]`` (a number passes at or below its limit).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# top-level modules no run may load (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "clipbert_tpu")
PROGRAM = "clipbert_tpu_torch"
DEADLINE_S = 1150.0
TIMEOUT_EXIT = 124


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``clipbert_tpu_torch`` is not ``clipbert_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Context:
    """What a driver is given: the cell, its configuration and traffic as
    loaded, the seed, the window's length, the device, the limits, and
    ``mode`` ("program", or "control": the lower precision the limits are
    set against)."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict, seed: int,
                 seconds: float, device, limits: Dict,
                 mode: str = "program"):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.device = device
        self.limits = limits
        self.mode = mode

    def log(self, msg: str) -> None:
        print(f"[{self.cell['name']}] {msg}", file=sys.stderr, flush=True)


def find_cell(spec: Dict, name: str):
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; workloads: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(spec: Dict, key: str, cell: str) -> List[Dict]:
    return [m for m in spec[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(spec: Dict, name: str, root: Path = ROOT):
    """(cell, config dict, traffic dict, driver module, limits dict)."""
    cell, centry = find_cell(spec, name)
    config = load_json(root / centry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    lpath = BENCH / "limits" / f"{name}.json"
    limits = load_json(lpath) if lpath.exists() else {}
    return cell, config, traffic, driver, limits


class LaunchRecorder:
    """While on, every launch of each kernel of ``benchmark/rooflines/``
    is recorded with its shape, at the port's launch function; the port
    runs as it would."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.kernels: Dict[str, Any] = {}
        self.shapes: Dict[str, List] = {}
        self._saved: List = []

    def __enter__(self) -> "LaunchRecorder":
        if not self.enabled:
            return self
        for path in sorted((BENCH / "rooflines").glob("*.py")):
            if path.name.startswith("_"):
                continue
            kern = load_module(path, f"benchmark_roofline_{path.stem}")
            self.kernels[path.stem] = kern
            self.shapes[path.stem] = []
            try:
                mod = importlib.import_module(kern.MODULE)
                orig = getattr(mod, kern.FUNCTION)
            except (ImportError, AttributeError) as e:
                print(f"roofline {path.stem}: cannot record launches: {e}",
                      file=sys.stderr)
                continue
            rec = self.shapes[path.stem]

            def wrapped(*args, _orig=orig, _kern=kern, _rec=rec, **kw):
                _rec.append(_kern.shape(args, kw))
                return _orig(*args, **kw)

            setattr(mod, kern.FUNCTION, wrapped)
            self._saved.append((mod, kern.FUNCTION, orig))
        return self

    def __exit__(self, *exc) -> bool:
        for mod, fn, orig in self._saved:
            setattr(mod, fn, orig)
        self._saved.clear()
        return False


def device_kind(device) -> Dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "kind": "cpu"}


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


class Watchdog:
    """Prints a failed result line and ends the process with code 124 if
    the run is still going after ``deadline_s``: a hung kernel or loader
    cannot be interrupted from Python."""

    def __init__(self, deadline_s: float, emit: Callable[[Dict], None],
                 stage: Callable[[], str],
                 hard_exit: Callable[[int], None] = os._exit):
        self.deadline_s = deadline_s
        self.emit = emit
        self.stage = stage
        self.hard_exit = hard_exit
        self._timer: Optional[threading.Timer] = None

    def __enter__(self) -> "Watchdog":
        if self.deadline_s > 0:
            self._timer = threading.Timer(self.deadline_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def _fire(self) -> None:
        self.emit({"error": f"timeout after {self.deadline_s:.0f} s in "
                            f"{self.stage()}"})
        sys.stderr.flush()
        sys.stdout.flush()
        self.hard_exit(TIMEOUT_EXIT)

    def __exit__(self, *exc) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        return False


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, spec: Optional[Dict] = None,
             device=None, require_chips: bool = True, mode: str = "program",
             config_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None,
             limits_override: Optional[Dict] = None,
             deadline_s: float = DEADLINE_S,
             hard_exit: Callable[[int], None] = os._exit,
             out=None) -> int:
    """One run; prints the result line to ``out`` (stdout) and returns the
    exit code. The overrides stand in for the files (tests run a cell at a
    tiny size on the CPU with them)."""
    out = out or sys.stdout
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"the program under test, {PROGRAM}, is not in this checkout",
              file=sys.stderr)
        return 2
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic, driver, limits = load_cell(spec, name)
    config = config_override or config
    traffic = traffic_override or traffic
    limits = limits if limits_override is None else limits_override
    import torch
    chips = int(cell["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if require_chips and seen < chips:
        print(f"{name} needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    if device is None:
        device = torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")
    ctx = Context(cell, config, traffic, seed, seconds, device, limits,
                  mode)
    stage = ["setup"]
    printed = threading.Lock()
    dev_info = dict(device_kind(device), count=chips)

    def emit(body: Dict) -> None:
        with printed:
            line = {"correct": False, "attempted": 0, "failed": 0,
                    "metrics": {}, "device": dev_info}
            line.update(body)
            print(json.dumps(line), file=out, flush=True)

    with Watchdog(deadline_s, emit, lambda: stage[0], hard_exit):
        try:
            return _run(ctx, spec, driver, trace, t_start, stage, emit,
                        dev_info)
        except Exception as e:          # the line says what failed
            traceback.print_exc()
            emit({"error": f"{type(e).__name__} in {stage[0]}: {e}"[:1500]})
            return 1


def _run(ctx: Context, spec: Dict, driver, trace: bool, t_start: float,
         stage: List[str], emit, dev_info: Dict) -> int:
    import torch
    from benchmark.devtrace import Tracer
    device = ctx.device
    name = ctx.cell["name"]
    # the traffic's host threads for torch's CPU ops, and a traced run's
    # shorter window, where the mix sets them
    if ctx.traffic.get("torch_threads"):
        torch.set_num_threads(int(ctx.traffic["torch_threads"]))
    if trace and ctx.traffic.get("trace_seconds"):
        ctx.seconds = min(ctx.seconds, float(ctx.traffic["trace_seconds"]))
    state = driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    ctx.log(f"setup {setup_s:.2f} s")
    stage[0] = "window"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with Tracer(device, enabled=trace) as tracer, \
            LaunchRecorder(enabled=trace) as recorder:
        res = driver.window(state, ctx)
    ctx.log(f"window {tracer.trace.window_s:.2f} s: {res['e2e']}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = {"cell": name, "config": ctx.config, "traffic": ctx.traffic,
           "window_s": tracer.trace.window_s, "trace": tracer.trace
           if trace else None, "launch_shapes": recorder.shapes,
           "rooflines": recorder.kernels, "device": dev_info, **res}
    metrics: Dict[str, Dict] = {}
    if trace:
        stage[0] = "per-layer metrics"
        for m in cell_metrics(spec, "per_layer", name):
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(spec, "end_to_end", name):
            value = setup_s if m["name"] == "setup_s" \
                else res["e2e"].get(m["name"])
            if value is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    stage[0] = "release"
    driver.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stage[0] = "check"
    numbers = driver.check(state, ctx)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = {}
    correct = True
    for key, value in numbers.items():
        limit = ctx.limits.get(key)
        ok = _finite(value) and limit is not None and value <= limit
        correct = correct and ok
        checks[key] = {"value": value, "limit": limit}
    if not numbers:
        correct = False
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    device_out = dict(dev_info, memory_peak_bytes=int(peak))
    line = {"correct": bool(correct and res.get("failed", 0) == 0),
            "attempted": int(res.get("attempted", 0)),
            "failed": int(res.get("failed", 0)),
            "metrics": metrics, "device": device_out}
    if trace:
        t = tracer.trace
        device_out["busy_s"] = t.busy_s
        device_out["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                             "idle_gaps": [list(x) for x in t.idle_gaps]}
    line["checks"] = checks
    stage[0] = "done"
    emit(line)
    return 0
