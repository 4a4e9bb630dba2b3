"""The benchmark of clipbert_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload msrvtt_ret.eval_1kcap --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout. Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from a profiled window
(``--trace 1``) as the last line of standard output; see
``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only the first run of a checkout builds. The port's own kernels
    build into ``clipbert_tpu_torch/_build/``, also inside it."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # transformers, where present, must not load JAX or flax
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()
    # the checkout root, in place of this script's folder, whose module
    # names must not shadow others
    sys.path[0] = str(ROOT)
    from benchmark import harness
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
