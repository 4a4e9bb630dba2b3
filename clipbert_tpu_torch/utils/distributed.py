"""Host-level distributed helpers (port of clipbert_tpu/utils/distributed.py)
over torch.distributed, and a launcher of local rank processes.

Each helper is the identity when no process group is initialized, as the
JAX package's are on a single host. The device collectives of the
tensor-parallel path live beside the code that needs them
(ops/linear.py::dense_row_parallel, train/steps.py).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in rank order (replaces the
    reference's all_gather_list, src/utils/distributed.py:148-177)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """The root process's picklable ``obj`` on every process (replaces
    any_broadcast, src/utils/distributed.py:180-203); only the root's
    payload crosses."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def _rank_main(fn, rank, world, backend, init_file, args, out, threads,
               timeout_s):
    from clipbert_tpu_torch.core.mesh import init_distributed
    try:
        torch.set_num_threads(threads)
        init_distributed(backend, f"file://{init_file}", world, rank,
                         timeout_s)
        result = fn(rank, world, *args)
        dist.destroy_process_group()
        payload = ("ok", result)
    except Exception:
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)
    # exit at once: a rank whose peers failed must not wait on them in the
    # process group's teardown
    os._exit(0 if payload[0] == "ok" else 1)


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
                backend: str, workdir: str, timeout_s: float,
                threads: int = 1) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes joined into one process group over ``backend``, through a
    FileStore rendezvous under ``workdir`` (no TCP port to collide); return
    each rank's result, in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function); each
    result is sent back pickled through a file. The parent joins every
    rank: a rank that raises or exits non-zero, or a group that outlives
    ``timeout_s``, stops every rank still running and raises here with
    each failed rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "rendezvous")
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file} is left from another group")
    outs = [os.path.join(workdir, f"rank{r}.pkl") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init_file, args,
                               outs[r], threads, timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"still running after {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()
    results, errors = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        status, value = "error", f"exit code {p.exitcode}, no result"
        if os.path.exists(out):
            with open(out, "rb") as f:
                status, value = pickle.load(f)
        if status != "ok" or p.exitcode != 0:
            errors.append(f"rank {r} (exit code {p.exitcode}):\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError(f"{fn.__name__} failed on {len(errors)} of "
                           f"{world_size} ranks:\n" + "\n".join(errors))
    return results
