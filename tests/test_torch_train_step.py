"""The port's train step (train/steps.py::make_train_step) against the JAX
package's on the CPU, at accum 1 on the retrieval head with LSE pooling and
CE (the MSRVTT config's loss): loss, grad norm, the gradients (read from
the first update's moments, mu = (1 - b1) g, so the JAX step compiles once)
and the parameters after the update. Then, on the port alone: remat on
equals remat off (CNN and BERT, with dropout on: the recompute draws the
same masks), and the kernel wrappers refuse autograd and stay off the
train step even where kernels_default says a device runs them.

Tiny sizes: 2 layers, hidden 32, 64^2 frames through the full ResNet-50,
fp32, dropout 0 for the parity. Tolerances: loss and grad norm rtol 1e-5.
Transformer moments rtol 1e-4 / atol 1e-9 and its parameters after the
update atol 1e-6 (fp32 sums in another order). The CNN's gradients come
through 53 convs whose ReLU masks flip where a pre-activation sits within
rounding of 0: the port's own gradients move by percents of a leaf's
largest element between thread counts, or with oneDNN on and off, so a CNN
moment is held within 3% of its leaf's largest element, and a CNN
parameter within 1e-4 after the update (10% of lr 1e-3: Adam's first step
is lr * g / (|g| + 7.1e-6), so an element's gap grows as its gradient
nears 0). A wiring fault moves them by O(1) and O(lr)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import flatten_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.train import optim as j_optim
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch import ops
from clipbert_tpu_torch.ckpt.from_jax import (load_jax_params, model_state,
                                              port_values, to_jax_flat)
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert, resnet
from clipbert_tpu_torch.ops import attention
from clipbert_tpu_torch.train import optim, steps
from test_torch_heads import random_params

LOSS_TOL = dict(rtol=1e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-9)
PARAM_TOL = dict(rtol=0, atol=1e-6)
CNN_MOMENT_REL = 3e-2        # of the leaf's largest |element|
CNN_PARAM_TOL = dict(rtol=0, atol=1e-4)
MODEL_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8, num_labels=2,
                vocab_size=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
B_V, N_CLIPS, NUM_FRM, IMG, GROUP, TXT = 2, 2, 1, 64, 2, 8
OPT = dict(learning_rate=1e-3, cnn_learning_rate=1e-3, grad_norm=5.0,
           weight_decay=1e-3, cnn_weight_decay=1e-3)
SCHED = dict(learning_rate=1e-3, cnn_learning_rate=1e-3, num_train_steps=10)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batch(rng, b_v):
    ids = rng.integers(1, 64, (b_v * GROUP, TXT)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, TXT - 2:] = 0
    return {"visual_inputs": (rng.standard_normal(
                (b_v, N_CLIPS * NUM_FRM, IMG, IMG, 3)) * 50).astype(
                    np.float32),
            "text_input_ids": ids, "text_input_mask": mask,
            "labels": np.tile([1, 0], b_v).astype(np.int32)}


def settings(agg):
    kw = dict(head_type="retrieval", score_agg_func=agg,
              train_n_clips=N_CLIPS, group_size=GROUP)
    return j_steps.TaskSettings(**kw), steps.TaskSettings(**kw)


def jax_step(params, batch, agg, accum):
    """One JAX make_train_step update (compiled once) -> (metrics, flat
    params, flat mu)."""
    jcfg = JModelConfig(**MODEL_KW)
    jts, _ = settings(agg)
    joc = j_optim.OptimConfig(**OPT)
    meta = j_optim.build_group_meta(params, joc)
    step = j_steps.make_train_step(
        jcfg, jts, joc, j_steps.ScheduleSettings(**SCHED), meta,
        accum_steps=accum, compute_dtype=jnp.float32)
    state = j_steps.init_train_state(jax.tree.map(jnp.asarray, params))
    state, m = step(state, jax.tree.map(jnp.asarray, batch),
                    jax.random.key(0))
    return ({k: float(v) for k, v in m.items()},
            flatten_tree(jax.tree.map(np.asarray, state.params)),
            flatten_tree(jax.tree.map(np.asarray, state.opt.mu)))


def port_step(params, batch, agg, accum, remat=False, dropout=0.0,
              seed=0):
    """The port's update from the same weights -> (metrics, model,
    state)."""
    cfg = ModelConfig(**dict(MODEL_KW, hidden_dropout_prob=dropout,
                             attention_probs_dropout_prob=dropout))
    _, ts = settings(agg)
    ts = steps.TaskSettings(**{**ts.__dict__, "remat": remat})
    oc = optim.OptimConfig(**OPT)
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"),
                            params)
    meta = optim.build_group_meta(model, oc)
    state = steps.init_train_state(model, meta)
    step = steps.make_train_step(cfg, ts, oc, steps.ScheduleSettings(**SCHED),
                                 meta, accum_steps=accum,
                                 compute_dtype=torch.float32)
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, seed)
    return m, model, state


def check_against_jax(jax_out, port_out, params):
    jm, jparams, jmu = jax_out
    m, model, state = port_out
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], **LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               **LOSS_TOL)
    assert m["lr"] == jm["lr"] and m["cnn_lr"] == jm["cnn_lr"]
    assert state.opt.step == 1
    mu = port_values(jmu)
    for n, t in state.opt.mu.items():
        if n.startswith("cnn."):
            np.testing.assert_allclose(
                t.numpy(), mu[n], rtol=0, err_msg=n,
                atol=CNN_MOMENT_REL * np.abs(mu[n]).max())
        else:
            np.testing.assert_allclose(t.numpy(), mu[n], err_msg=n,
                                       **MOMENT_TOL)
    got = to_jax_flat(model_state(model))
    before = flatten_tree(params)
    for k, want in jparams.items():
        np.testing.assert_allclose(
            got[k], want, err_msg=k,
            **(CNN_PARAM_TOL if k.startswith("cnn/") else PARAM_TOL))
        if "/bn/" in k:                     # frozen BN: bit-unchanged
            assert np.array_equal(got[k], before[k]), k
    moved = [k for k in jparams if "/bn/" not in k
             and not np.array_equal(got[k], before[k])]
    assert len(moved) == sum("/bn/" not in k for k in jparams)


@pytest.fixture(scope="module")
def world():
    jcfg = JModelConfig(**MODEL_KW)
    params = random_params(jcfg, "retrieval", 0)
    batch = make_batch(np.random.default_rng(0), B_V)
    return params, batch


def test_train_step_matches_jax(world):
    params, batch = world
    check_against_jax(jax_step(params, batch, "lse", 1),
                      port_step(params, batch, "lse", 1), params)


@pytest.fixture(scope="module")
def no_remat(world):
    params, batch = world
    return port_step(params, batch, "lse", 1, dropout=0.1, seed=5)


@pytest.mark.parametrize("remat", [True, "block"])
def test_remat_equals_no_remat(world, no_remat, remat):
    """Checkpointed CNN stages / blocks and BERT layers recompute the same
    forward, dropout masks included: the update equals the stored one."""
    params, batch = world
    ref_m, _, ref_state = no_remat
    m, model, state = port_step(params, batch, "lse", 1, remat=remat,
                                dropout=0.1, seed=5)
    assert float(m["loss"]) == float(ref_m["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-6)
    for n, t in state.opt.mu.items():
        np.testing.assert_allclose(t.numpy(), ref_state.opt.mu[n].numpy(),
                                   rtol=1e-5, atol=1e-10, err_msg=n)


def test_kernel_guard_refuses_autograd():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.refuse_autograd("matmul_bn_act", torch.ones(2), x)
    with torch.no_grad():
        ops.refuse_autograd("matmul_bn_act", x)
    with torch.inference_mode():
        ops.refuse_autograd("fused_attention", x)
    ops.refuse_autograd("fused_stem_pool", torch.ones(2), None)


def test_train_step_takes_the_plain_forms_where_kernels_run(world,
                                                           monkeypatch):
    """With kernels_default patched to True (as on a CUDA device), the
    eval forward reaches the kernel wrappers, and the train step reaches
    none of them: it passes use_kernels=False and fused_attn=False."""
    params, batch = world
    called = []

    def wrapper(name):
        def fn(*a, **k):
            called.append(name)
            raise RuntimeError(f"{name} called")
        return fn

    for mod, name in ((resnet, "fused_stem_pool"),
                      (resnet, "conv1x1_bn_act"),
                      (attention, "fused_attention"),
                      (attention, "fused_attention_shard_heads")):
        monkeypatch.setattr(mod, name, wrapper(name))
    monkeypatch.setattr(resnet, "kernels_default", lambda d: True)
    monkeypatch.setattr(steps, "kernels_default", lambda d: True)
    cfg = ModelConfig(**MODEL_KW)
    _, ts = settings("lse")
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"),
                            params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="fused_stem_pool called"):
        steps.mil_forward(model, cfg, ts, tb, torch.float32)
    step = steps.make_eval_step(cfg, ts, torch.float32, use_kernels=False)
    with pytest.raises(RuntimeError, match="fused_attention called"):
        step(model, tb)
    called.clear()
    m, _, _ = port_step(params, batch, "lse", 1)
    assert called == [] and np.isfinite(float(m["loss"]))
