"""Training across processes: the port's make_train_step under a mesh,
data- and tensor-parallel, against the JAX package on the CPU, on the
retrieval head with LSE pooling (the pretraining steps and the trainer are
in tests/test_torch_parallel_trainer.py).

The JAX reference is make_train_step with no mesh on the global batch (the
JAX step on a mesh is the same program, split by GSPMD), at accum_steps 1
and 2 (compiled in two threads).
The port's ranks run over gloo (clipbert_tpu_torch.utils.distributed.
spawn_ranks, a FileStore rendezvous under tmp_path, two threads a rank) in
two groups, spawned at once and run while the JAX step compiles:

 - 2 ranks: data-parallel (2 x 1) steps on the two halves of the global
   batch at accum 1 and at accum 2 (held to the JAX step at accum 2, and
   at accum 1 on the whole batch: half the micro-batch across 2 processes
   equals one update on the whole), and a tensor-parallel (1 x 2) step on
   the whole of it;
 - 4 ranks: a (2 x 2) step, data and tensor parallel at once, and one
   with dropout on.

Each rank's loss, grad norm, metrics, updated parameters and moments (its
shards, where the model axis cuts a leaf) equal the JAX step's, within
tests/test_torch_train_step.py's bounds except two absolute parts
(PAR_MOMENT_TOL, PAR_CNN_PARAM_TOL); the replicas of a data group end
bit-identical. The rank programs are tests/torch_parallel_train_ranks.py
(torch only)."""

import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import flatten_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.train import optim as j_optim
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt.from_jax import port_values
from clipbert_tpu_torch.parallel import tp_split_dim
from clipbert_tpu_torch.utils.distributed import spawn_ranks
from test_torch_heads import random_params
from test_torch_train_step import (CNN_MOMENT_REL, CNN_PARAM_TOL, GROUP,
                                   LOSS_TOL, MODEL_KW, MOMENT_TOL, N_CLIPS,
                                   OPT, PARAM_TOL, SCHED, make_batch)
from tests import torch_parallel_train_ranks

# a group's spawn to join takes ~20-40 s here; the timeout leaves room for
# a loaded machine
SPAWN_TIMEOUT_S = 240
# torch threads a rank: the one-process parity tests' count (their
# _few_torch_threads); on one thread oneDNN takes another conv path whose
# CNN gradients sit further from XLA's
RANK_THREADS = 2
B_V = 4                       # visuals in the global retrieval batch
# The bounds are test_torch_train_step.py's, except two absolute parts. A
# data- or tensor-parallel step sums each gradient in other partial sums
# (per rank, then across ranks) than one process does: elements that are
# small differences of large terms move by ~1 ulp of the terms. Measured
# on this box, at the one-process bounds: the retrieval head's output
# bias moments (their two elements are +-g, a sum over examples that
# nearly cancels) 1.1-1.3x the bound, one element of the tied word
# embedding's moment 1.5x (tensor-parallel pretraining), two CNN leaves'
# updated parameters 1.25-1.4x (data-parallel pretraining). So a moment
# takes atol 1e-8 (10x) and a CNN parameter 2e-4 (2x); every relative
# part, the loss, the norm, the metrics and the transformer parameters
# keep the one-process bounds.
PAR_MOMENT_TOL = dict(MOMENT_TOL, atol=1e-8)
PAR_CNN_PARAM_TOL = dict(CNN_PARAM_TOL, atol=2e-4)
RET_TS = dict(head_type="retrieval", score_agg_func="lse",
              train_n_clips=N_CLIPS, group_size=GROUP)


def _jax_update(params, batch, ts_kw, accum):
    """One JAX make_train_step update (no mesh) -> the metrics and the
    updated parameters and moments, by port name in the port's layout."""
    jcfg = JModelConfig(**MODEL_KW)
    joc = j_optim.OptimConfig(**OPT)
    meta = j_optim.build_group_meta(params, joc)
    step = j_steps.make_train_step(
        jcfg, j_steps.TaskSettings(**ts_kw), joc,
        j_steps.ScheduleSettings(**SCHED), meta, accum_steps=accum,
        compute_dtype=jnp.float32)
    state = j_steps.init_train_state(jax.tree.map(jnp.asarray, params))
    state, m = step(state, jax.tree.map(jnp.asarray, batch),
                    jax.random.key(0))

    def port(tree):
        return port_values(flatten_tree(jax.tree.map(np.asarray, tree)))

    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": port(state.params), "mu": port(state.opt.mu),
            "nu": port(state.opt.nu)}


def _stack_micros(batch, accum, group):
    """The JAX accum batch whose global micro-batch i holds visual i of
    each data rank's block (torch_parallel_train_ranks.data_shard)."""
    b_v = batch["visual_inputs"].shape[0]
    blocks = np.arange(b_v).reshape(-1, accum)

    def take(v_rows):
        t_rows = (v_rows[:, None] * group + np.arange(group)).reshape(-1)
        return {k: v[v_rows if k == "visual_inputs" else t_rows]
                for k, v in batch.items()}

    micros = [take(blocks[:, i]) for i in range(accum)]
    return {k: np.stack([m[k] for m in micros]) for k in batch}


def step_job(name, mp, tree, cfg_kw, ts_kw, batch, accum=1):
    """A rank job: one make_train_step(mesh=) update on a (world / mp, mp)
    mesh (torch_parallel_train_ranks.train_step)."""
    return (name, "train_step", (mp, tree, cfg_kw, ts_kw, OPT, SCHED, batch,
                                 accum))


def run_groups(tmp_path_factory, groups, local_work):
    """Spawn each group ({world size: jobs}) over gloo, in threads, run
    ``local_work()`` in this process meanwhile, join; returns ({world size:
    [rank 0's results, rank 1's, ...], "spawn_s": {world size: seconds}},
    local_work's result)."""
    # (mktemp is not thread-safe)
    workdirs = {n: str(tmp_path_factory.mktemp(f"w{n}")) for n in groups}
    out, errors = {"spawn_s": {}}, []

    def spawn(n, jobs):
        t0 = time.perf_counter()
        try:
            out[n] = spawn_ranks(
                torch_parallel_train_ranks.run_jobs, n, (jobs,),
                backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                threads=RANK_THREADS, workdir=workdirs[n])
        except Exception as e:        # re-raised in the test process
            errors.append(e)
        finally:
            # the ranks' result files hold ~1 GB of weights and moments
            shutil.rmtree(workdirs[n], ignore_errors=True)
        out["spawn_s"][n] = time.perf_counter() - t0

    threads = [threading.Thread(target=spawn, args=kv)
               for kv in groups.items()]
    for t in threads:
        t.start()
    try:
        local = local_work()
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return out, local


@pytest.fixture(scope="module")
def ret_inputs():
    params = random_params(JModelConfig(**MODEL_KW), "retrieval", 1)
    return (jax.tree.map(np.asarray, params),
            make_batch(np.random.default_rng(1), B_V))


@pytest.fixture(scope="module")
def results(tmp_path_factory, ret_inputs):
    """The ranks' results ({world size: [rank 0's, rank 1's, ...]}) and
    the JAX reference, compiled while the two groups run."""
    tree, batch = ret_inputs
    dropout_kw = dict(MODEL_KW, hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    groups = {
        2: [step_job("ret_2x1", 1, tree, MODEL_KW, RET_TS, batch),
            step_job("ret_2x1_accum2", 1, tree, MODEL_KW, RET_TS, batch, 2),
            step_job("ret_1x2", 2, tree, MODEL_KW, RET_TS, batch)],
        4: [step_job("ret_2x2", 2, tree, MODEL_KW, RET_TS, batch),
            step_job("ret_2x2_dropout", 2, tree, dropout_kw, RET_TS,
                     {k: v[:len(v) // 2] for k, v in batch.items()})]}

    def references():
        with ThreadPoolExecutor(2) as pool:
            accum2 = pool.submit(_jax_update, tree,
                                 _stack_micros(batch, 2, GROUP), RET_TS, 2)
            return {1: _jax_update(tree, batch, RET_TS, 1),
                    2: accum2.result()}

    return run_groups(tmp_path_factory, groups, references)


def _shard(full, name, n_model, model_idx):
    dim = tp_split_dim(name)
    if dim is None or n_model == 1:
        return full
    return np.split(full, n_model, axis=dim)[model_idx]


def _close(got, want, err_msg, rtol=0.0, atol=0.0):
    """assert_allclose, with an in-place numpy test first (the CNN's 25M
    elements take seconds through assert_allclose)."""
    gap = got - want
    np.abs(gap, out=gap)
    bound = np.abs(want)
    bound *= rtol
    bound += atol
    if not (gap <= bound).all():
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=err_msg)


def _check_rank(got, want, n_model):
    """One rank's update against the JAX reference, its shards against
    the matching slices."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        if k in ("lr", "cnn_lr"):
            assert got["metrics"][k] == v, k
        else:
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k,
                                       **LOSS_TOL)
    _, m = got["idx"]
    assert set(got["mu"]) == set(got["nu"]) <= set(got["params"])
    assert got["params"], "no leaves to compare"
    for n, t in got["params"].items():
        w = _shard(want["params"][n], n, n_model, m)
        _close(t, w, n, **(PAR_CNN_PARAM_TOL if n.startswith("cnn.")
                           else PARAM_TOL))
    for key in ("mu", "nu"):
        for n, t in got[key].items():
            w = _shard(want[key][n], n, n_model, m)
            if n.startswith("cnn."):
                _close(t, w, f"{key} {n}",
                       atol=CNN_MOMENT_REL * np.abs(w).max())
            else:
                _close(t, w, f"{key} {n}", **PAR_MOMENT_TOL)


def check_case(outs, ref, shape):
    """Every rank's update equals the JAX step on the global batch; the
    ranks of a data group (same model index) hold bit-identical weights
    and moments afterwards, and the mesh is the one asked for."""
    n_data, n_model = shape
    world_size = n_data * n_model
    assert [o["idx"] for o in outs] == [divmod(r, n_model)
                                        for r in range(world_size)]
    for o in outs:
        if o["idx"][0] == 0:            # row 0; the digests cover the rest
            _check_rank(o, ref, n_model)
        else:
            assert not o["params"]
    for m in range(n_model):
        digests = {o["digest"] for o in outs if o["idx"][1] == m}
        assert len(digests) == 1, m


# name -> (the rank job, its mesh shape, the JAX reference's accum_steps)
CASES = {"ret_2x1": ("ret_2x1", (2, 1), 1),
         "ret_2x1_accum2": ("ret_2x1_accum2", (2, 1), 2),
         "ret_1x2": ("ret_1x2", (1, 2), 1),
         "ret_2x2": ("ret_2x2", (2, 2), 1),
         # accumulation 2 at half the micro-batch across 2 processes holds
         # to the JAX step at accum 1 on the whole batch too (equal
         # micro-batches average to the whole batch's mean loss)
         "ret_2x1_accum2_vs_accum1": ("ret_2x1_accum2", (2, 1), 1)}


@pytest.fixture(scope="module")
def checked(results):
    """Each case's check_case outcome (None, or the AssertionError it
    raised), the cases run in threads: numpy releases the GIL in the
    comparisons of the CNN's 25M elements."""
    out, ref = results

    def run(case):
        job, (n_data, n_model), accum = CASES[case]
        try:
            check_case([r[job] for r in out[n_data * n_model]], ref[accum],
                       (n_data, n_model))
        except AssertionError as e:
            return e
        return None

    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(run, CASES)))


@pytest.mark.parametrize("case", list(CASES))
def test_retrieval_step_matches_jax(checked, case):
    """Data-parallel (2 x 1) at accum 1 and 2, tensor-parallel (1 x 2) and
    both (2 x 2): the JAX step on the global batch at the same accum (and
    the accum-2 ranks at accum 1)."""
    if checked[case] is not None:
        raise checked[case]


def test_ranks_draw_their_own_dropout_masks(results):
    """With dropout on, on a (2 x 2) mesh: the two data rows draw
    different masks (their seeds fold in the data index); the two model
    ranks of a row draw the same masks on the replicated activations
    (the embeddings') and their own on their heads' attention
    probabilities (those seeds fold in the model index: one process draws
    every head's independently); the replicas of a data group still end
    bit-identical."""
    out, _ = results
    r = [o["ret_2x2_dropout"] for o in out[4]]
    assert all(o["draws"] is not None and o["attn_draws"] is not None
               for o in r)
    np.testing.assert_array_equal(r[0]["draws"], r[1]["draws"])
    np.testing.assert_array_equal(r[2]["draws"], r[3]["draws"])
    assert r[0]["draws"].shape == r[2]["draws"].shape
    assert not np.array_equal(r[0]["draws"], r[2]["draws"])
    heads = MODEL_KW["num_attention_heads"] // 2
    for o in r:
        assert o["attn_draws"].shape[1] == heads, o["attn_draws"].shape
    for a, b in ((0, 1), (2, 3), (0, 2)):
        assert not np.array_equal(r[a]["attn_draws"], r[b]["attn_draws"])
    for m in range(2):
        assert r[m]["digest"] == r[2 + m]["digest"]
    assert all(np.isfinite(o["metrics"]["loss"]) for o in r)
