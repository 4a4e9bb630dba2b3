"""Rank programs for tests/test_torch_parallel_train.py: each runs in a
process of its own, started by clipbert_tpu_torch.utils.distributed.
spawn_ranks over gloo on the CPU, and returns numpy results to the test
process. This module imports torch and the port only: the ranks never load
JAX."""

import os
import sys

import numpy as np
import torch

from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params, model_state
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import make_mesh
from clipbert_tpu_torch.models import bert, clipbert
from clipbert_tpu_torch.ops import attention
from clipbert_tpu_torch.parallel import shard_model
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.train import optim, steps, trainer
from clipbert_tpu_torch.utils import distributed, logger


def data_shard(batch, n_data, data_idx, accum, group):
    """This data rank's share of a global batch: a contiguous block of the
    visuals (and of their ``group`` texts each) at accum 1; at accum 2 the
    global micro-batch i holds visual ``i`` of every rank's block, so this
    rank's micro-batches are its block's visuals in order, stacked."""
    b_v = batch["visual_inputs"].shape[0] // n_data
    rows = np.arange(data_idx * b_v, (data_idx + 1) * b_v)

    def take(v_rows):
        t_rows = (v_rows[:, None] * group + np.arange(group)).reshape(-1)
        return {k: v[v_rows if k == "visual_inputs" else t_rows]
                for k, v in batch.items()}

    if accum == 1:
        return take(rows)
    micros = [take(rows[i::accum]) for i in range(accum)]
    return {k: np.stack([m[k] for m in micros]) for k in batch}


def _record_first_dropout_draws(module):
    """Wrap ``module``'s dropout so its first masked call records its
    uniform draws, from a copy of its generator: models/bert.py's first is
    the text embeddings', ops/attention.py's the first layer's attention
    probabilities' (this rank's heads)."""
    seen = []
    inner = module.dropout

    def recorded(x, rate, generator):
        if generator is not None and rate > 0 and not seen:
            g = torch.Generator(device=x.device)
            g.set_state(generator.get_state())
            seen.append(torch.rand(x.shape, generator=g,
                                   device=x.device).numpy())
        return inner(x, rate, generator)

    module.dropout = recorded
    return seen, inner


def train_step(rank, world, model_parallel, tree, cfg_kw, ts_kw, opt_kw,
               sched_kw, batch, accum, seed=0):
    """One make_train_step(mesh=) update on a fresh (world / mp, mp) mesh
    from the tree's weights, cut to this rank's shards, on this rank's data
    shard of the global ``batch``. Returns the metrics, the mesh index, a
    digest of every tensor, the first dropout draws (the embeddings' and
    the attention probabilities'), and the updated
    parameters and both moments by port name (shards where cut): the
    encoder's leaves from each rank of data row 0, the rest (replicated on
    every rank) from rank 0 only. The digests show the other data rows
    equal to row 0."""
    mesh = make_mesh(model_parallel)
    cfg = ModelConfig(**cfg_kw)
    ts = steps.TaskSettings(**ts_kw)
    oc = optim.OptimConfig(**opt_kw)
    model = load_jax_params(clipbert.empty_clipbert(cfg, ts.head_type,
                                                    device="cpu"), tree)
    shard_model(model, mesh)
    meta = optim.build_group_meta(model, oc)
    state = steps.init_train_state(model, meta)
    step = steps.make_train_step(cfg, ts, oc, steps.ScheduleSettings(
        **sched_kw), meta, accum_steps=accum, compute_dtype=torch.float32,
        mesh=mesh)
    local = data_shard(batch, mesh.n_data, mesh.data_idx, accum,
                       ts.group_size)
    seen, inner = _record_first_dropout_draws(bert)
    seen_attn, inner_attn = _record_first_dropout_draws(attention)
    try:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in local.items()}, seed)
    finally:
        bert.dropout, attention.dropout = inner, inner_attn

    def keep(n):
        return mesh.data_idx == 0 and (
            rank == 0 or (".encoder." in n and mesh.n_model > 1))

    def host(tensors):
        return {n: t.detach().numpy().copy() for n, t in tensors.items()
                if keep(n)}

    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": host(model_state(model)),
            "mu": host(state.opt.mu), "nu": host(state.opt.nu),
            "idx": (mesh.data_idx, mesh.model_idx),
            "digest": distributed.tensors_digest(
                trainer.replica_tensors(state)),
            "draws": seen[0] if seen else None,
            "attn_draws": seen_attn[0] if seen_attn else None}


def _record_writes():
    """Wrap the port's file writers the trainer reaches (checkpoint npz
    writes, the training meta, the scalar logger, save_json); returns the
    list the paths are appended to."""
    writes = []

    def wrap(owner, name):
        inner = getattr(owner, name)

        def recorded(*args, **kwargs):
            path = args[1] if name in ("create", "save_json") else args[0]
            writes.append((name, str(path)))
            return inner(*args, **kwargs)
        setattr(owner, name, recorded)

    wrap(checkpoint, "_write_npz")
    wrap(checkpoint, "save_training_meta")
    wrap(type(trainer.TB_LOGGER), "create")
    wrap(rvr, "save_json")
    return writes


def _record_losses():
    """Wrap make_train_step so every step's loss is appended to a list."""
    losses = []
    inner = steps.make_train_step

    def making(*args, **kwargs):
        step = inner(*args, **kwargs)

        def recorded(state, batch, seed):
            state, m = step(state, batch, seed)
            losses.append(float(m["loss"]))
            return state, m
        return recorded

    steps.make_train_step = making
    return losses


def trainer_run(rank, world, argv, rendezvous):
    """The retrieval trainer as each process of a launch runs it, in the
    spawner's process group: ``run_video_retrieval.main`` gets the launch
    flags (``--coordinator_address file://... --num_processes
    --process_id``), finds the group joined and checks that they name it.
    Rank 1's ``--output_dir`` is its own (output directories not shared
    across hosts), so only rank 0 sees the restore bundle. A stop signal on
    rank 0 alone ends that run after its first step on both ranks (a
    restore bundle at step 1); a second ``start_training(max_steps=2)`` in
    the same group resumes from it. Returns each run's per-step losses,
    history and final step, the files this rank wrote, its output
    directory's files, and a digest of the final weights and moments. The
    tensorboard package is hidden (its import costs seconds): the scalars
    go to log/scalars.jsonl."""
    sys.modules["torch.utils.tensorboard"] = None
    trainer.TB_LOGGER = logger.TensorboardLogger()
    writes, losses = _record_writes(), _record_losses()
    real_train = trainer.train
    if rank:
        at = argv.index("--output_dir") + 1
        argv = argv[:at] + [f"{argv[at]}_rank{rank}"] + argv[at + 1:]

    def train_one_step(*args, **kwargs):
        polls = []
        kwargs["stop_signal"] = (lambda: polls.append(1) or len(polls) > 1) \
            if rank == 0 else (lambda: False)
        return real_train(*args, **kwargs)

    trainer.train = train_one_step
    try:
        first = rvr.main(argv + [
            "--coordinator_address", f"file://{rendezvous}",
            "--num_processes", str(world), "--process_id", str(rank)])
    finally:
        trainer.train = real_train
    first_losses = list(losses)
    cfg = rvr.load_run_config(argv)
    second = rvr.start_training(cfg, max_steps=2)
    return {"losses": [first_losses, losses[len(first_losses):]],
            "steps": [first["global_step"], second["global_step"]],
            "opt_step": second["state"].opt.step,
            "val": [[h.get("val") for h in r["history"]]
                    for r in (first, second)],
            "writes": writes,
            "backend": torch.distributed.get_backend(),
            "digest": distributed.tensors_digest(
                trainer.replica_tensors(second["state"])),
            "out_files": (sorted(os.listdir(cfg.output_dir))
                          if os.path.isdir(cfg.output_dir) else [])}


def run_jobs(rank, world, jobs):
    """Run each (key, function name, args) of ``jobs`` in order on this
    rank, in one process group; returns {key: result}."""
    return {key: globals()[fn](rank, world, *args) for key, fn, args in jobs}
