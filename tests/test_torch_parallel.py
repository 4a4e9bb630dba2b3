"""The port's multi-process and tensor-parallel inference against the JAX
package, on the CPU.

The JAX side runs in this process on conftest's 8 CPU devices:
make_text_prob_step on (data, model) meshes over the first 2 or 4 of
them, with the Megatron param split (parallel/sharding.py) and the Pallas
kernels in interpret mode. The port side runs in spawned rank processes
(clipbert_tpu_torch.utils.distributed.spawn_ranks, gloo, a FileStore
rendezvous under tmp_path, one intra-op thread each): each world size is
spawned once per module by a fixture, which runs every job of that size
(tests/torch_parallel_ranks.py), and the parametrised cases read its
results. Weights cross with ckpt/from_jax.py; inputs come from numpy.

Tolerances: scoring rtol 1e-5, atol 1e-6 in fp32, the JAX tensor-parallel
test's own (tests/test_pallas_kernels.py:279); eval rtol 2e-4, atol 2e-5
with equal R@K, tests/test_torch_eval.py's bound.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import ModelSaver
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.core.mesh import data_shard, make_mesh as j_make_mesh
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.ops import pallas_attention
from clipbert_tpu.parallel.sharding import param_shardings
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt import from_jax
from clipbert_tpu_torch.core import mesh as port_mesh
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.parallel import tp_split_dim
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils.distributed import spawn_ranks
from test_torch_eval import (_DS_KW, N_VIDEOS, RUN_KW, jax_eval,  # noqa: F401
                             random_params, world)
from tests import torch_parallel_ranks

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
EVAL_TOL = dict(rtol=2e-4, atol=2e-5)
# a group's spawn to join took 14-17 s (2 ranks) and 18-21 s (4 ranks) on
# six pytest workers, in the whole suite and beside other heavy files; the
# timeout leaves ~6x that for a loaded machine
SPAWN_TIMEOUT_S = 120
# tests/test_pallas_kernels.py:235-241
CFG_KW = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_grid_row_position_embeddings=8,
              max_grid_col_position_embeddings=8, num_labels=2)
TS_KW = dict(head_type="retrieval", loss_type="ce", score_agg_func="lse",
             train_n_clips=2, group_size=1)
# (name, world size, model axis, attention core): "mesh" is the JAX
# fused_attn=mesh (the port's fused_attn=True on a tensor-parallel mesh:
# fused_attention_shard_heads), True runs the core on the whole step
CASES = [("tp_1x2", 2, 2, "mesh"), ("tp_1x2_einsum", 2, 2, False),
         ("dp_2x1", 2, 1, True), ("tp_2x2", 4, 2, "mesh"),
         ("tp_1x4", 4, 4, "mesh"), ("dp_4x1", 4, 1, True)]


@pytest.fixture(scope="module")
def scoring_inputs():
    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((2, 2, 1, 3, 3, 32)) * 0.1).astype(
        np.float32)
    ids = rng.integers(0, 64, (8, 7)).astype(np.int64)
    mask = np.ones((8, 7), np.int64)
    mask[:, 5:] = 0
    return {"params": random_params(JModelConfig(**CFG_KW), 5),
            "feats": feats, "ids": ids, "mask": mask}


@pytest.fixture(scope="module")
def row_inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((3, 5, 64)).astype(np.float32),
            (rng.standard_normal((24, 64)) * 0.2).astype(np.float32),
            rng.standard_normal(24).astype(np.float32))


def _jobs(world_size, scoring_inputs, row_inputs, eval_args, cli_args):
    si = scoring_inputs
    tree = jax.tree.map(np.asarray, si["params"])
    cases = [(n, mp, f) for n, w, mp, f in CASES if w == world_size]
    jobs = [("scoring", "scoring", (cases, tree, CFG_KW, TS_KW, si["feats"],
                                    si["ids"], si["mask"])),
            ("row_parallel", "row_parallel", row_inputs),
            ("layout", "mesh_layout", (2,)),
            ("collectives", "host_collectives", ())]
    if eval_args is not None:
        jobs.append(("eval", "eval_retrieval", eval_args))
    if cli_args is not None:         # last: it leaves the group
        jobs.append(("cli", "eval_cli", cli_args))
    return jobs


def _eval_args(world):
    cfg = world["cfg"]
    return (jax.tree.map(np.asarray, world["params"]), cfg.to_dict(),
            RUN_KW, str(world["tok_dir"]), str(world["store"]),
            world["rows"], _DS_KW)


def _cli_args(world, root):
    """Flags of the eval CLI on a model_step_7.npz written by the JAX
    package's ModelSaver, and the rendezvous file of its launch."""
    out = root / "run"
    ModelSaver(str(out)).save(7, world["params"])
    mcfg = root / "model.json"
    mcfg.write_text(json.dumps(world["cfg"].to_dict()))
    flags = {"model_config": mcfg, "tokenizer_dir": world["tok_dir"],
             "output_dir": out, "inference_txt_db": world["txt"],
             "inference_img_db": world["store"], "bf16": 0, "device": "cpu",
             **RUN_KW}
    argv = ["--do_inference", "1"] + [a for k, v in flags.items()
                                      for a in (f"--{k}", str(v))]
    return argv, str(root / "cli_rendezvous")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scoring_inputs, row_inputs, world):
    """{world size: [rank 0's results, rank 1's, ...]}, each world size
    spawned once; ``ranks["spawn_s"]`` holds each group's seconds from
    spawn to join."""
    out = {"spawn_s": {}}
    for n in (2, 4):
        jobs = _jobs(n, scoring_inputs, row_inputs,
                     _eval_args(world) if n == 2 else None,
                     _cli_args(world, tmp_path_factory.mktemp("cli"))
                     if n == 2 else None)
        t0 = time.perf_counter()
        out[n] = spawn_ranks(torch_parallel_ranks.run_jobs, n, (jobs,),
                             backend="gloo", timeout_s=SPAWN_TIMEOUT_S,
                             workdir=str(tmp_path_factory.mktemp(f"w{n}")))
        out["spawn_s"][n] = time.perf_counter() - t0
    return out


def _jax_probs(si, world_size, model_parallel, fused):
    """JAX's make_text_prob_step on a (world / mp, mp) mesh of CPU devices,
    with the Megatron split when mp > 1."""
    cfg = JModelConfig(**CFG_KW)
    ts = j_steps.TaskSettings(num_labels=2, **TS_KW)
    mesh = j_make_mesh(jax.devices()[:world_size], model_parallel)
    params = jax.device_put(si["params"], param_shardings(
        si["params"], mesh, tensor_parallel=model_parallel > 1))
    ids = jax.device_put(si["ids"].astype(np.int32), data_shard(mesh))
    mask = jax.device_put(si["mask"].astype(np.int32), data_shard(mesh))
    step = j_steps.make_text_prob_step(
        cfg, ts, jnp.float32, fused_attn=mesh if fused == "mesh" else fused,
        mesh=mesh)
    return np.asarray(step(params, jnp.asarray(si["feats"]), ids, mask))


@pytest.mark.parametrize("name,world_size,model_parallel,fused", CASES,
                         ids=[c[0] for c in CASES])
def test_scoring_matches_jax_mesh(ranks, scoring_inputs, name, world_size,
                                  model_parallel, fused):
    """Every rank returns the whole (B_v, B_t) probability matrix, equal to
    JAX's on the same mesh; the tensor-parallel ranks hold D / n_model
    query rows, and a "mesh" core goes through
    fused_attention_shard_heads once per layer."""
    want = _jax_probs(scoring_inputs, world_size, model_parallel, fused)
    assert want.shape == (2, 8)
    for rank_out in ranks[world_size]:
        probs, calls, q_rows = rank_out["scoring"][name]
        np.testing.assert_allclose(probs, want, **SCORE_TOL)
        assert q_rows == CFG_KW["hidden_size"] // model_parallel
        assert calls == (CFG_KW["num_hidden_layers"] if fused == "mesh"
                         else 0)


@pytest.mark.parametrize("world_size", [2, 4])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_dense_row_parallel_matches_dense(ranks, world_size, dtype):
    """The row-parallel product on input and weight-column shards equals
    dense on the whole weight: fp32 sums in another order, then one cast
    (bf16: at most one bf16 rounding apart)."""
    tol = SCORE_TOL if dtype == "torch.float32" else dict(rtol=2 ** -7,
                                                          atol=1e-6)
    for rank_out in ranks[world_size]:
        got, want = rank_out["row_parallel"][dtype]
        assert got.shape == (3, 5, 24)
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("world_size", [2, 4])
def test_mesh_layout_is_row_major(ranks, world_size):
    """make_mesh(2): rank r at divmod(r, 2); its model group shares its
    data index, its data group its model index."""
    for r, rank_out in enumerate(ranks[world_size]):
        lay = rank_out["layout"]
        d, m = divmod(r, 2)
        assert lay["shape"] == {"data": world_size // 2, "model": 2}
        assert lay["idx"] == (d, m)
        assert lay["model_group"] == [2 * d, 2 * d + 1]
        assert lay["data_group"] == list(range(m, world_size, 2))


@pytest.mark.parametrize("world_size", [2, 4])
def test_host_collectives(ranks, world_size, record_property):
    # the group's spawn-to-join seconds, for the junit report
    record_property("spawn_s", round(ranks["spawn_s"][world_size], 2))
    for r, rank_out in enumerate(ranks[world_size]):
        c = rank_out["collectives"]
        assert (c["index"], c["count"], c["main"]) == (r, world_size, r == 0)
        assert c["gathered"] == [{"rank": i, "rows": list(range(i))}
                                 for i in range(world_size)]
        root = world_size - 1
        assert c["broadcast"] == ("from", root, [0, root, 2 * root])


def test_two_process_eval_matches_jax(ranks, jax_eval):
    """Two processes run inference_retrieval on test_torch_eval.py's store:
    rank 0 scores videos 0, 2, 4 and rank 1 videos 1, 3; both return the
    merged matrix, equal to the JAX runner's, with equal R@K."""
    want = jax_eval(True)
    outs = [rank_out["eval"] for rank_out in ranks[2]]
    assert [st["n_videos"] for _, st in outs] == [3, 2]
    for m, _ in outs:
        assert m["score_matrix"].shape == want["score_matrix"].shape
        np.testing.assert_allclose(m["score_matrix"], want["score_matrix"],
                                   **EVAL_TOL)
        for k in want:
            if k != "score_matrix":
                assert m[k] == want[k], k
    assert sum(st["n_videos"] for _, st in outs) == N_VIDEOS


def test_two_process_cli_writes_metrics_once(ranks, jax_eval):
    """``run_video_retrieval.main`` in two processes launched with
    ``--coordinator_address file://... --num_processes 2 --process_id i
    --device cpu``: each joins a gloo group (the CPU's backend), both
    return the JAX runner's matrix, and only the main process writes the
    metrics file."""
    want = jax_eval(True)
    outs = [rank_out["cli"] for rank_out in ranks[2]]
    for m, _, backend in outs:
        assert backend == "gloo"
        np.testing.assert_allclose(m["score_matrix"], want["score_matrix"],
                                   **EVAL_TOL)
    (m0, writes0, _), (_, writes1, _) = outs
    assert [os.path.basename(w) for w in writes0] == [
        "retrieval_metrics_step7.json"] and writes1 == []
    with open(writes0[0]) as f:
        assert json.load(f) == {k: v for k, v in m0.items()
                                if k != "score_matrix"}


def test_tp_split_dims_match_jax_shardings():
    """tp_split_dim on every port parameter equals the JAX Megatron spec of
    the leaf it is loaded from (ckpt/from_jax.py's names): a JAX split on
    dim d of a stacked (layers, in, out) kernel is weight dim 2 - d of the
    (out, in) nn.Linear weight, on dim d of a (layers, out) bias dim
    d - 1; replicated leaves are None."""
    cfg = JModelConfig(**CFG_KW)
    params = jax.eval_shape(lambda: j_clipbert.init_clipbert(
        jax.random.key(0), cfg, "retrieval"))
    mesh = j_make_mesh(jax.devices()[:2], 2)
    shardings = jax.tree_util.tree_flatten_with_path(
        param_shardings(params, mesh, tensor_parallel=True))[0]
    shapes = jax.tree.leaves(params)
    port_names = {n for n, _ in clipbert.empty_clipbert(
        ModelConfig(**CFG_KW), device="meta").named_parameters()}
    seen, n_split = set(), 0
    for (path, sharding), shape in zip(shardings, shapes):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                       for p in path)
        dims = [i for i, a in enumerate(sharding.spec) if a == "model"]
        kernel = key.endswith("kernel")
        for name, _ in from_jax._entries(key, np.zeros(shape.shape)):
            want = None
            if dims:
                d = dims[0]
                want = 2 - d if kernel else d - 1
                n_split += 1
            if name in port_names:
                assert tp_split_dim(name) == want, (key, name)
                seen.add(name)
    assert n_split == 10 * CFG_KW["num_hidden_layers"]
    assert {n for n in port_names if tp_split_dim(n) is not None} <= seen


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2), (1, 4)])
def test_shard_heads_matches_jax(n_data, n_model):
    """fused_attention_shard_heads on each rank's (batch, head) block of
    strided views of a merged QKV tensor, assembled, equals JAX's
    shard_map over the same mesh (Pallas in interpret mode)."""
    rng = np.random.default_rng(n_data * 10 + n_model)
    B, S, H, dh = 4, 9, 4, 8
    qkv = rng.standard_normal((B, S, 3, H, dh)).astype(np.float32)
    bias = np.where(rng.random((B, S)) < 0.3, -10000.0, 0.0).astype(
        np.float32)
    bias[:, 0] = 0.0
    scale = dh ** -0.5
    mesh = j_make_mesh(jax.devices()[:n_data * n_model], n_model)
    want = np.asarray(pallas_attention.fused_attention_shard_heads(
        *(jnp.asarray(qkv[:, :, i]) for i in range(3)), jnp.asarray(bias),
        scale, mesh))
    got = np.zeros_like(want)
    bl, hl = B // n_data, H // n_model
    for d in range(n_data):
        for m in range(n_model):
            rows, heads = slice(d * bl, (d + 1) * bl), slice(m * hl,
                                                             (m + 1) * hl)
            # this rank's merged local projection: (bl, S, 3 * hl * dh)
            local = torch.from_numpy(np.ascontiguousarray(
                qkv[rows, :, :, heads])).reshape(bl, S, 3 * hl * dh)
            q, k, v = (t.view(bl, S, hl, dh)
                       for t in local.split(hl * dh, dim=-1))
            out = fa.fused_attention_shard_heads(
                q, k, v, torch.from_numpy(bias[rows]), scale,
                Mesh(n_data, n_model, d, m), H)
            got[rows, :, heads] = out.numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    assert fa.LAUNCHES == 0 and fa.SHARD_HEADS_LAUNCHES == 0
    with pytest.raises(ValueError):
        fa.fused_attention_shard_heads(q, k, v, torch.from_numpy(bias[rows]),
                                       scale, Mesh(1, 3), 4)


def test_fused_attn_default_selector():
    """The JAX selector's modes (tests/test_pallas_kernels.py:268-284) on
    ops.kernels_default's rule: the CPU takes einsum; on a CUDA device a
    data-parallel or absent mesh takes the kernel, a tensor-parallel mesh
    takes it (on the local heads) when the heads split over it and einsum
    otherwise."""
    dp, tp = Mesh(2, 1), Mesh(1, 2)
    cuda = torch.device("cuda")
    assert steps.fused_attn_default(torch.device("cpu"), tp, 12) is False
    assert steps.fused_attn_default(cuda, None, 12) is True
    assert steps.fused_attn_default(cuda, dp, 12) is True
    assert steps.fused_attn_default(cuda, tp, 12) is True
    assert steps.fused_attn_default(cuda, tp, 5) is False


_TOPOLOGY_ENV = ("CLIPBERT_COORDINATOR", "CLIPBERT_NUM_PROCESSES",
                 "CLIPBERT_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE")


@pytest.mark.parametrize("flags,env", [
    (dict(num_processes=2), {}),
    (dict(process_id=1), {}),
    ({}, {"CLIPBERT_NUM_PROCESSES": "2"}),
    (dict(coordinator_address="localhost:1234"), {}),
    (dict(coordinator_address="localhost:1234", num_processes=2), {}),
], ids=["num_processes", "process_id", "env_num_processes",
        "coordinator_only", "no_process_id"])
def test_partial_topology_raises(monkeypatch, flags, env):
    """A partial launch topology must not turn into independent
    single-process runs (clipbert_tpu/core/mesh.py:75-84)."""
    for k in _TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        port_mesh.maybe_init_distributed(RunConfig(model_config="", **flags))
    assert not torch.distributed.is_initialized()


def test_no_topology_runs_single_process(monkeypatch):
    for k in _TOPOLOGY_ENV:
        monkeypatch.delenv(k, raising=False)
    assert port_mesh.maybe_init_distributed(RunConfig(model_config="")) \
        is False
    assert port_mesh.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        port_mesh.make_mesh(2)
