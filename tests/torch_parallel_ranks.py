"""Rank programs for tests/test_torch_parallel.py: each runs in a process
of its own, started by clipbert_tpu_torch.utils.distributed.spawn_ranks
over gloo on the CPU, and returns numpy results to the test process. This
module imports torch and the port only: the ranks never load JAX."""

import numpy as np
import torch

from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.core.mesh import make_mesh
from clipbert_tpu_torch.data import store, tokenization
from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import attention, fused_attention as fa
from clipbert_tpu_torch.ops.linear import dense, dense_row_parallel
from clipbert_tpu_torch.parallel import shard_model
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils import distributed


def _model(tree, cfg):
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"), tree)
    return model.eval().requires_grad_(False)


def _count_shard_heads_calls():
    """Wrap ops.attention's reference to fused_attention_shard_heads so the
    rank can say how often the scoring path went through it."""
    calls = [0]
    inner = attention.fused_attention_shard_heads

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    attention.fused_attention_shard_heads = counted
    return calls


def scoring(rank, world, cases, tree, cfg_kw, ts_kw, feats, ids, mask):
    """For each (name, model_parallel, fused) case: the seeded model,
    Megatron-split over a fresh (world / model_parallel, model_parallel)
    mesh, runs make_text_prob_step(fused_attn=..., mesh=...) in fp32.
    ``fused`` is "mesh" or True (the fused core: fused_attention_shard_heads
    on a tensor-parallel mesh, fused_attention on a data-parallel one) or
    False (einsum). Returns {name: (probs, number of
    fused_attention_shard_heads calls, query rows this rank holds)}."""
    cfg = ModelConfig(**cfg_kw)
    ts = steps.TaskSettings(**ts_kw)
    calls = _count_shard_heads_calls()
    out = {}
    for name, model_parallel, fused in cases:
        mesh = make_mesh(model_parallel)
        model = shard_model(_model(tree, cfg), mesh)
        calls[0] = 0
        step = steps.make_text_prob_step(
            cfg, ts, torch.float32, mesh=mesh,
            fused_attn=True if fused == "mesh" else fused)
        probs = step(model, torch.from_numpy(feats), torch.from_numpy(ids),
                     torch.from_numpy(mask))
        q_rows = model.transformer.bert.encoder.layers[0].attention.self \
            .query.weight.shape[0]
        out[name] = (probs.numpy(), calls[0], q_rows)
    assert fa.LAUNCHES == 0 and fa.SHARD_HEADS_LAUNCHES == 0
    return out


def row_parallel(rank, world, x, w, b):
    """dense_row_parallel on this rank's input and weight columns over a
    (1, world) mesh, fp32 and bf16, beside dense on the whole weight."""
    mesh = make_mesh(world)
    k = x.shape[-1] // world
    sl = slice(rank * k, (rank + 1) * k)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        wt, bt = torch.from_numpy(w), torch.from_numpy(b)
        got = dense_row_parallel(xt[..., sl], wt[:, sl], bt,
                                 mesh.model_group)
        out[str(dtype)] = (got.float().numpy(),
                           dense(xt, wt, bt).float().numpy())
    return out


def mesh_layout(rank, world, model_parallel):
    """This rank's place in make_mesh(model_parallel) and the global ranks
    of its two groups."""
    mesh = make_mesh(model_parallel)
    return {"shape": mesh.shape, "idx": (mesh.data_idx, mesh.model_idx),
            "data_group": torch.distributed.get_process_group_ranks(
                mesh.data_group),
            "model_group": torch.distributed.get_process_group_ranks(
                mesh.model_group)}


def host_collectives(rank, world):
    """all_gather_objects and broadcast_object on rank-dependent objects."""
    gathered = distributed.all_gather_objects(
        {"rank": rank, "rows": list(range(rank))})
    sent = distributed.broadcast_object(
        ("from", rank, np.arange(3) * rank), root=world - 1)
    return {"index": distributed.process_index(),
            "count": distributed.process_count(),
            "main": distributed.is_main_process(), "gathered": gathered,
            "broadcast": (sent[0], sent[1], sent[2].tolist())}


def eval_retrieval(rank, world, tree, cfg_kw, run_kw, tok_dir, store_path,
                   rows, ds_kw):
    """inference_retrieval on the store: this process's videos, the merged
    matrix and R@K."""
    cfg = ModelConfig(**cfg_kw)
    model = clipbert.fold_cnn_bn_scales(_model(tree, cfg))
    tok = tokenization.BertTokenizer.from_dir(tok_dir)
    ds = VideoRetrievalEvalDataset([dict(r, id=i) for i, r in enumerate(rows)],
                                   tok, store.open_store(store_path),
                                   device_preprocess=True, **ds_kw)
    stats = {}
    m = rvr.inference_retrieval(RunConfig(model_config="", **run_kw), cfg,
                                model, ds, torch.float32, stats)
    return m, stats


def eval_cli(rank, world, argv, rendezvous):
    """The eval CLI as each process of a 2-process launch runs it: this
    rank leaves the spawner's process group, and ``main`` joins its own
    through ``--coordinator_address file://... --num_processes
    --process_id``. Returns the metrics and the files this process
    wrote."""
    torch.distributed.destroy_process_group()
    writes = []
    save_json = rvr.save_json

    def recorded(obj, path, **kwargs):
        writes.append(path)
        return save_json(obj, path, **kwargs)

    rvr.save_json = recorded
    m = rvr.main(argv + ["--coordinator_address", f"file://{rendezvous}",
                         "--num_processes", str(world),
                         "--process_id", str(rank)])
    return m, writes, torch.distributed.get_backend()


def run_jobs(rank, world, jobs):
    """Run each (key, function name, args) of ``jobs`` in order on this
    rank, in one process group; returns {key: result}."""
    return {key: globals()[fn](rank, world, *args) for key, fn, args in jobs}
