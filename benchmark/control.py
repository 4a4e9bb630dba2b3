"""The readings a cell's limits are set from: the numbers its check
compares, for the program, for the control (the lower precision: the
port's int8 scoring path, or the reference in float8 in the program's
place) or for a planted fault (``benchmark/faults.py``), on several seeds
in one process. The benchmark's own runs never run this.

    python3 benchmark/control.py --workload msrvtt_ret.eval_1kcap \\
        --mode control --seeds 11,12,13 [--seconds 1]

Prints one JSON line a seed, then one with each number's largest and
smallest reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, mode: str, seeds, seconds: float, *,
             device=None, config_override=None, traffic_override=None,
             out=sys.stdout):
    """[{seed: numbers}] of ``mode`` ("program", "control" or
    "fault:<name>") on each seed."""
    import torch
    from benchmark import faults, harness
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic, driver, _ = harness.load_cell(spec, workload)
    config = config_override or config
    traffic = traffic_override or traffic
    if device is None:
        device = torch.device("cuda", 0)
    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    run_mode = "control" if mode == "control" else "program"
    rows = []
    for seed in seeds:
        ctx = harness.Context(cell, config, traffic, seed, seconds, device,
                              {}, run_mode)
        with (faults.planted(fault) if fault else contextlib.nullcontext()):
            state = driver.setup(ctx)
            res = driver.window(state, ctx)
        driver.release(state)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = driver.check(state, ctx)
        del state
        row = {"workload": workload, "mode": mode, "seed": seed,
               "numbers": numbers, "e2e": res["e2e"]}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    keys = rows[0]["numbers"] if rows else {}
    summary = {"workload": workload, "mode": mode, "seeds": list(seeds),
               "max": {k: max(r["numbers"][k] for r in rows) for k in keys},
               "min": {k: min(r["numbers"][k] for r in rows) for k in keys}}
    print(json.dumps(summary), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from benchmark import run as bench_run
    bench_run._pin_caches()             # the caches a run uses
    readings(args.workload, args.mode,
             [int(s) for s in args.seeds.split(",")], args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
