"""The port's training pieces that hold no model run against the JAX
package's, on the CPU: the LR schedules, the optimizer's 8 groups, one
AdamW / Adam / Adamax update on fixed gradients with clipping that
excludes frozen leaves, every loss type of ``task_loss``, and dropout's
statistics (its masks cannot match JAX's bits: tested on their own).

Tolerances: schedules within 1 fp32 ulp (rtol 1.2e-7: the same fp32
operations, XLA's against numpy's); the updated parameters and moments
rtol 1e-6 / atol 1e-7 (the same per-element fp32 expressions; XLA may
contract a multiply-add); the clip norm rtol 1e-6 (sums in another order);
losses rtol 1e-6 / atol 1e-7."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import flatten_tree, unflatten_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.train import optim as j_optim
from clipbert_tpu.train import sched as j_sched
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt.from_jax import jax_name, port_values
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops.dropout import dropout
from clipbert_tpu_torch.train import optim, sched, steps
from test_torch_heads import random_params

SCHED_TOL = dict(rtol=1.2e-7, atol=0)
UPD_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
MODEL_KW = dict(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=32,
                max_grid_row_position_embeddings=4,
                max_grid_col_position_embeddings=4, num_labels=2)


@pytest.mark.parametrize("decay", ["linear", "invsqrt", "constant",
                                   "multi_step"])
def test_schedules_match_jax(decay):
    kw = dict(learning_rate=3e-5, num_train_steps=57, warmup_ratio=0.1,
              decay_epochs=[2, 5] if decay == "multi_step" else None)
    for step in [0, 1, 2, 5, 6, 7, 20, 56, 57, 80]:
        epoch = step / 9.0
        want = j_sched.get_lr(step, decay, multi_step_epoch=epoch, **kw)
        got = sched.get_lr(step, decay, multi_step_epoch=np.float32(epoch),
                           **kw)
        assert isinstance(got, np.float32)
        np.testing.assert_allclose(got, np.asarray(want), **SCHED_TOL)
    jss = j_steps.ScheduleSettings(learning_rate=1e-4, cnn_learning_rate=2e-4,
                                   num_train_steps=40, decay=decay,
                                   cnn_decay="linear", steps_per_epoch=9,
                                   step_decay_epochs=(2, 5))
    ss = steps.ScheduleSettings(learning_rate=1e-4, cnn_learning_rate=2e-4,
                                num_train_steps=40, decay=decay,
                                cnn_decay="linear", steps_per_epoch=9,
                                step_decay_epochs=(2, 5))
    # the first update's lrs: the schedule at the post-increment step 1
    np.testing.assert_allclose(np.asarray(ss.lrs(1)),
                               np.asarray(jss.lrs(1)), **SCHED_TOL)


_SHAPES = {}


def _jax_shapes(head):
    """The JAX tree's structure for ``head`` (eval_shape, once a head)."""
    if head not in _SHAPES:
        jcfg = JModelConfig(**MODEL_KW)
        _SHAPES[head] = jax.eval_shape(lambda: j_clipbert.init_clipbert(
            jax.random.key(0), jcfg, head))
    return _SHAPES[head]


def _meta_of_jax(params, oc):
    meta = j_optim.build_group_meta(params, j_optim.OptimConfig(**oc))
    return dict(zip(flatten_tree(params), jax.tree.leaves(
        meta, is_leaf=lambda x: isinstance(x, j_optim.GroupMeta))))


@pytest.mark.parametrize("head", ["retrieval", "pretrain", "regression"])
@pytest.mark.parametrize("freeze_cnn", [False, True])
def test_group_ids_match_jax(head, freeze_cnn):
    """Every port parameter lands in its JAX leaf's group with its lr_mul
    and weight decay; every frozen JAX leaf is a port buffer or a frozen
    parameter; the tied MLM decoder is one parameter, in the embedding's
    group."""
    oc = dict(transformer_lr_mul=10.0, transformer_lr_mul_prefix="pooler",
              cnn_lr_mul=3.0, cnn_lr_mul_prefix="grid_encoder",
              weight_decay=0.01, cnn_weight_decay=0.02,
              freeze_cnn=freeze_cnn)
    cfg = ModelConfig(**MODEL_KW)
    jmeta = _meta_of_jax(_jax_shapes(head), oc)
    model = clipbert.empty_clipbert(cfg, head, device="cpu")
    meta = optim.build_group_meta(model, optim.OptimConfig(**oc))
    for n, gm in meta.items():
        assert tuple(gm) == tuple(jmeta[jax_name(n)[0]]), n
    params = dict(model.named_parameters())
    buffers = {jax_name(n)[0] for n, _ in model.named_buffers()}
    for key, gm in jmeta.items():
        if gm.trainable:
            continue
        assert key in buffers or any(
            jax_name(n)[0] == key and not meta[n].trainable for n in params)
    counts = optim.count_groups(meta)
    assert set(counts) - {-1} == {gm.group_id for gm in jmeta.values()
                                  if gm.trainable}
    if head == "pretrain":
        emb = model.transformer.bert.embeddings.word_embeddings.weight
        assert model.transformer.mlm_decoder_weight is emb
        assert sum(p is emb for p in params.values()) == 1
        groups = optim.param_groups(model, meta)
        assert sum(n.endswith("word_embeddings.weight")
                   for n in groups[2]) == 1


@pytest.fixture(scope="module")
def update_world():
    """A JAX tree cut to the stem, res2's first block and the rest (every
    kind of leaf, a third of the leaves, so each JAX compile is short) and
    two sets of gradients."""
    jcfg, cfg = JModelConfig(**MODEL_KW), ModelConfig(**MODEL_KW)
    params = random_params(jcfg, "retrieval", 0)
    resnet = params["cnn"]["resnet"]
    params["cnn"]["resnet"] = {"stem": resnet["stem"],
                               "res2": resnet["res2"][:1]}
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32),
        params) for _ in range(2)]
    return jcfg, cfg, params, grads


@pytest.mark.parametrize("name,fused", [("adamw", False), ("adamw", True),
                                        ("adam", False), ("adamax", False)])
def test_update_matches_jax(update_world, name, fused):
    """Two updates on fixed gradients, clipping on (norm ~ 9 against 1.0):
    parameters, moments and the norm equal the JAX update's, per leaf or
    group-fused. The frozen leaves' gradients (the BN pairs) are huge and
    change nothing: the norm excludes them, as the reference clips its 8
    groups only."""
    jcfg, cfg, params, grads = update_world
    kw = dict(optim=name, grad_norm=1.0, weight_decay=0.01,
              cnn_weight_decay=0.02, cnn_lr_mul=3.0,
              transformer_lr_mul=2.0, transformer_lr_mul_prefix="classifier")
    joc, oc = j_optim.OptimConfig(**kw), optim.OptimConfig(**kw)
    jmeta = j_optim.build_group_meta(params, joc)
    model = clipbert.empty_clipbert(cfg, device="cpu")
    values = port_values(params)
    with torch.no_grad():
        for n, t in model.named_parameters():
            if n in values:
                t.copy_(torch.from_numpy(values[n]))
    meta = optim.build_group_meta(model, oc)
    state = optim.init_adamw_state(model, meta)
    jp, jstate = jax.tree.map(jnp.asarray, params), \
        j_optim.init_adamw_state(params)
    jupdate = jax.jit(lambda p, g, s, lt, lc: j_optim.adamw_update(
        p, g, s, jmeta, joc, lt, lc, fused=fused))
    kept = set(flatten_tree(params))
    port = {n: p for n, p in model.named_parameters()
            if jax_name(n)[0] in kept}
    for i, g in enumerate(grads):
        g = dict(g)
        flat = flatten_tree(g)
        for k in flat:
            if "/bn/" in k:
                flat[k] = flat[k] * 1e4     # frozen: must not count
        jg = jax.tree.map(jnp.asarray, unflatten_tree(flat))
        lr_t, lr_c = np.float32(1e-3 * (i + 1)), np.float32(5e-4)
        jp, jstate, jnorm = jupdate(jp, jg, jstate, jnp.float32(lr_t),
                                    jnp.float32(lr_c))
        pg = port_values(flat)
        norm = optim.adamw_update(
            port, {n: torch.from_numpy(pg[n]) for n in port}, state, meta,
            oc, lr_t, lr_c)
        np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm),
                                   rtol=1e-6)
        assert float(jnorm) > 1.0                  # clipping is active
    assert state.step == int(jstate.step) == 2
    want = {k: port_values({k2: np.asarray(v) for k2, v in
                            flatten_tree(t).items()})
            for k, t in (("p", jp), ("m", jstate.mu), ("v", jstate.nu))}
    for n, p in port.items():
        np.testing.assert_allclose(p.detach().numpy(), want["p"][n],
                                   err_msg=n, **UPD_TOL)
        np.testing.assert_allclose(state.mu[n].numpy(), want["m"][n],
                                   err_msg=n, **UPD_TOL)
        np.testing.assert_allclose(state.nu[n].numpy(), want["v"][n],
                                   err_msg=n, **UPD_TOL)


def _task_case(case, rng):
    """(JAX TaskSettings, port TaskSettings, batch, clip logits (B, nc,
    L)) for one head / loss / aggregation."""
    B, nc = 6, 3
    kw = {"lse": dict(head_type="retrieval", score_agg_func="lse"),
          "ce": dict(head_type="retrieval", score_agg_func="mean"),
          "rank": dict(head_type="retrieval", score_agg_func="max",
                       loss_type="rank", num_labels=1, margin=0.3),
          "bce": dict(head_type="seq_cls", score_agg_func="mean",
                      loss_type="bce", num_labels=5,
                      scale_loss_by_num_labels=True),
          "mse": dict(head_type="regression", score_agg_func="mean",
                      loss_type="mse", num_labels=1),
          "cls_ce": dict(head_type="seq_cls", score_agg_func="max",
                         num_labels=4),
          "multi_choice": dict(head_type="multi_choice",
                               score_agg_func="mean", num_labels=5)}[case]
    L = kw.get("num_labels", 2)
    logits = (rng.standard_normal((B, nc, L)) * 2).astype(np.float32)
    if case == "bce":
        labels = rng.random((B, L)).astype(np.float32)
    elif case == "mse":
        labels = rng.standard_normal(B).astype(np.float32)
    else:
        labels = rng.integers(0, L, B).astype(np.int32)
    batch = {"labels": labels,
             "visual_inputs": np.zeros((3 if case == "rank" else B, 1),
                                       np.float32)}
    return (j_steps.TaskSettings(train_n_clips=nc, **kw),
            steps.TaskSettings(train_n_clips=nc, **kw), batch, logits)


@pytest.mark.parametrize("case", ["lse", "ce", "rank", "bce", "mse",
                                  "cls_ce", "multi_choice"])
def test_task_loss_matches_jax(case):
    rng = np.random.default_rng(7)
    jts, ts, batch, logits = _task_case(case, rng)
    jloss, jm = j_steps.task_loss(
        None, jts, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(logits))
    loss, m = steps.task_loss(
        None, ts, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(logits))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **LOSS_TOL)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   **LOSS_TOL)
    if case == "lse":
        labels = batch["labels"]
        np.testing.assert_allclose(
            steps.lse_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels)).numpy(),
            np.asarray(j_steps.lse_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))), **LOSS_TOL)


def test_dropout_statistics():
    x = torch.randn(1000, 1000, generator=torch.Generator().manual_seed(0))
    assert dropout(x, 0.0, torch.Generator()) is x
    assert dropout(x, 0.1, None) is x
    rate = 0.1
    y = dropout(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    share = kept.float().mean().item()
    # binomial with n = 1e6: 4 standard deviations is 1.2e-3
    assert abs(share - (1 - rate)) < 4 * (rate * (1 - rate) / x.numel()) ** .5
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    again = dropout(x, rate, torch.Generator().manual_seed(3))
    assert torch.equal(again, y)
    other = dropout(x, rate, torch.Generator().manual_seed(4))
    assert not torch.equal(other != 0, kept)
    xb = x.bfloat16()
    yb = dropout(xb, rate, torch.Generator().manual_seed(3))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)
