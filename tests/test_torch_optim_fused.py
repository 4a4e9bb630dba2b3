"""The port's group-fused AdamW update (train/optim.py::adamw_update)
against its per-leaf form (adamw_update_per_leaf), on the CPU, and which
form the train step takes.

The fused form runs the per-leaf expressions once per optimizer group as
``torch._foreach_*`` ops in the same order, so without clipping every
parameter and moment is bit-equal to the per-leaf form's. With clipping
the norm sums in another order: the norm within rtol 1e-6 and the leaves
within rtol 2e-6 / atol 1e-7, the JAX package's own fused-versus-per-leaf
tolerance (tests/test_optim.py). The fused form against the JAX updates is
tests/test_torch_train_optim.py::test_update_matches_jax."""

import functools

import numpy as np
import pytest
import torch

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.train import optim, steps

NORM_TOL = dict(rtol=1e-6)
LEAF_TOL = dict(rtol=2e-6, atol=1e-7)
MODEL_KW = dict(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=32,
                max_grid_row_position_embeddings=4,
                max_grid_col_position_embeddings=4, num_labels=2)
OPT_KW = dict(weight_decay=0.01, cnn_weight_decay=0.02, cnn_lr_mul=3.0,
              transformer_lr_mul=2.0, transformer_lr_mul_prefix="classifier")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Two threads: a worker of a parallel run shares the cores, and
    OpenMP's idle threads spin through the thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kept(name):
    """Every transformer leaf, the stem and res2's first block: each kind
    of leaf in a tenth of the CNN's elements."""
    return (not name.startswith("cnn") or ".stem." in name
            or ".res2.0." in name)


def _world(seed, freeze_cnn=False, **kw):
    """(params, their gradients for 3 updates, meta, config): seeded
    values, the gradients ~0.3 so the norm (~20) clips at 1.0."""
    cfg = ModelConfig(**MODEL_KW)
    model = clipbert.empty_clipbert(cfg, device="cpu")
    oc = optim.OptimConfig(**dict(OPT_KW, freeze_cnn=freeze_cnn, **kw))
    meta = optim.build_group_meta(model, oc)
    rng = np.random.default_rng(seed)
    params = {}
    for n, p in model.named_parameters():
        if _kept(n):
            params[n] = torch.from_numpy(
                (rng.standard_normal(p.shape) * 0.05).astype(np.float32))
    grads = [{n: torch.from_numpy((rng.standard_normal(p.shape) * 0.3)
                                  .astype(np.float32))
              for n, p in params.items()} for _ in range(3)]
    return params, grads, meta, oc


def _run(params, grads, meta, oc, fused):
    """Three updates on copies of ``params``: (params, state, norms)."""
    update = optim.adamw_update if fused else optim.adamw_update_per_leaf
    params = {n: p.clone() for n, p in params.items()}
    state = optim.AdamWState(
        0, {n: torch.zeros_like(p) for n, p in params.items()
            if meta[n].trainable},
        {n: torch.zeros_like(p) for n, p in params.items()
         if meta[n].trainable})
    norms = []
    for i, g in enumerate(grads):
        kept = {n: t.clone() for n, t in g.items()}
        norms.append(update(
            params, g, state, meta, oc, np.float32(1e-3 * (i + 1)),
            np.float32(5e-4)))
        for n, t in g.items():             # the caller's gradients stay
            assert torch.equal(t, kept[n]), n
    return params, state, norms


def _compare(a, b, exact):
    (pa, sa, na), (pb, sb, nb) = a, b
    assert sa.step == sb.step == 3
    for x, y in zip(na, nb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **NORM_TOL)
    for mine, theirs in ((pa, pb), (sa.mu, sb.mu), (sa.nu, sb.nu)):
        assert mine.keys() == theirs.keys()
        for n in mine:
            if exact:
                assert torch.equal(mine[n], theirs[n]), n
            else:
                np.testing.assert_allclose(mine[n].numpy(),
                                           theirs[n].numpy(), err_msg=n,
                                           **LEAF_TOL)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("name", ["adamw", "adam", "adamax"])
def test_fused_matches_per_leaf(name, clip):
    """Weight decay on (the decay groups) and off (biases, LayerNorm) in
    one model; bit-equal without clipping."""
    params, grads, meta, oc = _world(
        3, optim=name, grad_norm=1.0 if clip else -1.0)
    per_leaf = _run(params, grads, meta, oc, fused=False)
    fused = _run(params, grads, meta, oc, fused=True)
    _compare(fused, per_leaf, exact=not clip)
    moved = [n for n in params if not torch.equal(per_leaf[0][n], params[n])]
    assert len(moved) == len(params)
    if clip:
        assert float(per_leaf[2][0]) > 1.0          # clipping is active


@pytest.mark.parametrize("clip", [False, True])
def test_fused_skips_frozen_leaves(clip):
    """freeze_cnn: the CNN's parameters neither move nor count in the norm,
    in both forms; the rest as above."""
    params, grads, meta, oc = _world(4, freeze_cnn=True,
                                     grad_norm=1.0 if clip else -1.0)
    frozen = [n for n in params if not meta[n].trainable]
    assert frozen and all(n.startswith("cnn") for n in frozen)
    for g in grads:
        for n in frozen:
            g[n] = g[n] * 1e4                   # would dominate the norm
    per_leaf = _run(params, grads, meta, oc, fused=False)
    fused = _run(params, grads, meta, oc, fused=True)
    _compare(fused, per_leaf, exact=not clip)
    for n in frozen:
        assert torch.equal(fused[0][n], params[n]), n
    assert float(fused[2][0]) < 100.0


def test_fused_on_a_fully_frozen_model():
    """No trainable leaf: the count moves, nothing else, norm 0."""
    params, grads, meta, oc = _world(5)
    meta = {n: gm._replace(trainable=False, group_id=-1)
            for n, gm in meta.items()}
    for fused in (False, True):
        out, state, norms = _run(params, grads, meta, oc, fused=fused)
        assert state.step == 3 and not state.mu and not state.nu
        assert all(float(x) == 0.0 for x in norms)
        for n in params:
            assert torch.equal(out[n], params[n])


def test_a_split_takes_the_per_leaf_form(monkeypatch):
    """adamw_update with a ``split`` runs the per-leaf form, whose norm sums
    the split leaves over the model group: with one model rank (the
    all-reduce a no-op) and clipping off, the leaves are bit-equal to
    adamw_update_per_leaf's without a split, the norm within NORM_TOL."""
    params, grads, meta, oc = _world(6, grad_norm=-1.0)
    split = (frozenset(n for n in params if "attention" in n), None)
    assert split[0]
    want = _run(params, grads, meta, oc, fused=False)
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: None)
    calls = []
    real = optim.adamw_update_per_leaf

    def rec(*a, **k):
        calls.append(a[7])
        return real(*a, **k)
    monkeypatch.setattr(optim, "adamw_update_per_leaf", rec)
    monkeypatch.setattr(optim, "adamw_update", functools.partial(
        optim.adamw_update, split=split))
    got = _run(params, grads, meta, oc, fused=True)
    assert calls == [split] * 3
    _compare(got, want, exact=True)


def _step_world():
    cfg = ModelConfig(**dict(MODEL_KW, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0))
    gen = torch.Generator().manual_seed(0)
    model = clipbert.init_clipbert(cfg, "retrieval", generator=gen,
                                   device="cpu")
    oc = optim.OptimConfig(**OPT_KW)
    meta = optim.build_group_meta(model, oc)
    ts = steps.TaskSettings(head_type="retrieval", score_agg_func="lse",
                            train_n_clips=1, group_size=2)
    ss = steps.ScheduleSettings(learning_rate=1e-3, cnn_learning_rate=1e-3,
                                num_train_steps=10)
    rng = np.random.default_rng(7)
    batch = {"visual_inputs": torch.from_numpy(
                 rng.standard_normal((1, 1, 64, 64, 3)).astype(np.float32)),
             "text_input_ids": torch.from_numpy(
                 rng.integers(1, 40, (2, 6)).astype(np.int64)),
             "text_input_mask": torch.ones(2, 6, dtype=torch.int64),
             "labels": torch.tensor([1, 0])}
    return cfg, model, oc, meta, ts, ss, batch


def _recording(monkeypatch, calls, stub=False):
    real = optim.adamw_update

    def rec(*a, **k):
        calls.append(k.get("split"))
        return torch.zeros(()) if stub else real(*a, **k)
    monkeypatch.setattr(optim, "adamw_update", rec)


def test_train_step_takes_the_fused_update(monkeypatch):
    """Without a mesh make_train_step runs the fused form, which updates
    the model; the per-leaf form on the same gradients agrees."""
    cfg, model, oc, meta, ts, ss, batch = _step_world()
    calls = []
    _recording(monkeypatch, calls)
    state = steps.init_train_state(model, meta)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = steps.make_train_step(cfg, ts, oc, ss, meta,
                                 compute_dtype=torch.float32)
    _, m = step(state, batch, 0)
    assert calls == [None]
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moved = [n for n, p in model.named_parameters()
             if meta[n].trainable and not torch.equal(p, before[n])]
    assert moved


def test_train_step_takes_the_per_leaf_update_under_a_split(monkeypatch):
    """Under a model axis (a 1 x 2 mesh) the step passes the split leaves
    and the per-leaf form. The forward's collectives are outside this
    test: the loss is stubbed to a function of every parameter (the
    tensor-parallel step itself runs in tests/test_torch_parallel_train.py)."""
    cfg, model, oc, meta, ts, ss, batch = _step_world()
    calls = []
    _recording(monkeypatch, calls, stub=True)

    def loss(model, *a, **k):
        total = sum((p.float() ** 2).sum() for p in model.parameters()
                    if p.requires_grad)
        return total, {}
    monkeypatch.setattr(steps, "compute_loss", loss)
    state = steps.init_train_state(model, meta)
    step = steps.make_train_step(cfg, ts, oc, ss, meta,
                                 compute_dtype=torch.float32,
                                 mesh=Mesh(1, 2))
    step(state, batch, 0)
    (split,) = calls
    assert split is not None and any("attention" in n for n in split[0])
