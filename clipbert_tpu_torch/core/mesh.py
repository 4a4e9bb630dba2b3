"""Process mesh over torch.distributed (port of clipbert_tpu/core/mesh.py).

The JAX package lays its devices out as a (data, model) ``jax.sharding.Mesh``
and lets GSPMD insert the collectives. Here one process drives one device
(one rank), and a :class:`Mesh` says where this rank sits in the same
(data, model) grid and holds the two process groups the port's collectives
run over:

 - ``model_group``: the ranks that share this rank's data index. The
   Megatron split (parallel/sharding.py) spreads one replica of the BERT
   encoder over them, and the row-parallel products all-reduce over it
   (ops/linear.py::dense_row_parallel).
 - ``data_group``: the ranks that share this rank's model index. They score
   different caption shards, gathered over it (train/steps.py).

Ranks are laid out row-major as ``np.array(devices).reshape(n_data,
n_model)`` lays out devices: rank ``r`` sits at ``divmod(r, n_model)``.

The backend is always named by the caller of :func:`init_distributed`
(the task runners name :func:`default_backend` of their device): ``nccl``
when each rank owns its own card, ``gloo`` for CPU tensors, or for ranks
that share one card (NCCL refuses two ranks on one device; gloo's
all_reduce, all_gather and broadcast take CUDA tensors through the host).
Nothing here picks another backend when the chosen one fails.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def default_backend(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device (one rank per card), ``gloo`` for the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``, 0 when unset."""
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(device: torch.device | str) -> torch.device:
    """The device this rank runs on: ``cuda`` without an index becomes
    ``cuda:{LOCAL_RANK}``; anything else is the caller's."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int, timeout_s: float = 600.0) -> None:
    """Join the process group (replaces the JAX package's
    jax.distributed.initialize): ``init_method`` is ``tcp://host:port``,
    ``file:///path`` or ``env://``. With ``nccl`` this rank's card becomes
    the current device first."""
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _flag(cfg, name: str, env: str) -> int:
    v = getattr(cfg, name, -1)
    v = -1 if v is None else int(v)
    return v if v >= 0 else int(os.environ.get(env, -1))


def maybe_init_distributed(cfg=None) -> bool:
    """Runner-entry bootstrap (clipbert_tpu/core/mesh.py:42-97): every task
    ``main`` calls it before it first touches the device.

    Joins a process group iff a launch topology is given:
    ``--coordinator_address/--num_processes/--process_id`` (or their
    ``CLIPBERT_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}`` environment
    equivalents; the coordinator is ``host:port`` or an init-method URL),
    or torchrun's ``RANK``/``WORLD_SIZE`` (with ``MASTER_ADDR``, through
    ``env://``). Plain single-process runs stay zero-config. A partial
    topology raises: it must not turn into N independent single-process
    runs that each believe they are the main process. The backend is
    :func:`default_backend` of ``cfg.device``. Idempotent: in a group this
    process has already joined (its launcher's) nothing is joined, and
    ``num_processes``/``process_id``, where given, must name that group's
    size and this rank. Returns True when a process group is (already)
    initialized."""
    coord = (getattr(cfg, "coordinator_address", None)
             or os.environ.get("CLIPBERT_COORDINATOR") or None)
    nproc = _flag(cfg, "num_processes", "CLIPBERT_NUM_PROCESSES")
    pid = _flag(cfg, "process_id", "CLIPBERT_PROCESS_ID")
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if nproc not in (-1, world) or pid not in (-1, rank):
            raise ValueError(
                f"num_processes/process_id ({nproc}, {pid}) do not name "
                f"the process group already joined (rank {rank} of {world})")
        return True
    torchrun = "MASTER_ADDR" in os.environ and "RANK" in os.environ
    if coord is None and torchrun:
        coord = "env://"
        nproc = nproc if nproc >= 0 else int(os.environ.get("WORLD_SIZE", -1))
        pid = pid if pid >= 0 else int(os.environ["RANK"])
    if coord is None:
        if nproc > 0 or pid >= 0:
            raise ValueError(
                "num_processes/process_id given without a coordinator "
                "address: set --coordinator_address or "
                "CLIPBERT_COORDINATOR (or unset the partial topology)")
        return False
    if nproc <= 0 or pid < 0:
        raise ValueError(
            f"coordinator {coord!r} given without num_processes and "
            f"process_id ({nproc}, {pid}): pass all three (or launch with "
            "torchrun)")
    init_method = coord if "://" in coord else f"tcp://{coord}"
    init_distributed(default_backend(getattr(cfg, "device", "cuda")),
                     init_method, nproc, pid)
    return True


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups.
    Without a process group: one rank, 1 x 1, and no groups."""

    n_data: int
    n_model: int
    data_idx: int = 0
    model_idx: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self):
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(model_parallel: int = 1) -> Mesh:
    """A (world / model_parallel, model_parallel) mesh over every rank.

    Every rank creates every subgroup, in the same order (torch.distributed
    requires each ``new_group`` call on all ranks); each keeps its own two.
    With no process group initialized this is the 1 x 1 mesh."""
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs "
                             f"{model_parallel} ranks; no process group is "
                             "initialized")
        return Mesh(1, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks do not split into model groups of "
                         f"{model_parallel}")
    n_data = world // model_parallel
    data_idx, model_idx = divmod(rank, model_parallel)
    data_group = model_group = None
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(n_data)])
        if m == model_idx:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * model_parallel + m
                            for m in range(model_parallel)])
        if d == data_idx:
            model_group = g
    return Mesh(n_data, model_parallel, data_idx, model_idx, data_group,
                model_group)
