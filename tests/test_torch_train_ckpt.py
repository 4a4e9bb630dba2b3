"""Checkpoint interchange between the port and the JAX package, both ways:
the port's deploy checkpoints (ModelSaver) and restore bundles
(TrainingRestorer, trainer.restore_bundle) are read by the JAX
``load_tree`` / ``TrainingRestorer`` into its own tree schema, and bundles
the JAX package writes are resumed by the port (trainer.load_bundle); the
restorer's rotation, torn-file fallback and write-error surfacing; and the
trainer's setup_model on a JAX-written ``.npz``. Values are compared
exactly: the files hold fp32 arrays that both sides copy."""

import os

import numpy as np
import pytest
import torch

import jax

from clipbert_tpu.ckpt import checkpoint as j_ckpt
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.train import optim as j_optim
from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import (load_jax_params, model_state,
                                              to_jax_flat)
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.train import optim, steps, trainer
from test_torch_heads import random_params

MODEL_KW = dict(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=32,
                max_grid_row_position_embeddings=4,
                max_grid_col_position_embeddings=4, num_labels=2)


def _flat(tree):
    return j_ckpt.flatten_tree(jax.tree.map(np.asarray, tree))


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = JModelConfig(**MODEL_KW), ModelConfig(**MODEL_KW)
    params = random_params(jcfg, "retrieval", 4)
    return jcfg, cfg, params


def _port_state(cfg, params, seed=0):
    """A port TrainState on the JAX weights, with random moments and an
    update count."""
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"),
                            params)
    meta = optim.build_group_meta(model, optim.OptimConfig())
    state = steps.init_train_state(model, meta)
    g = torch.Generator().manual_seed(seed)
    for d in (state.opt.mu, state.opt.nu):
        for t in d.values():
            t.copy_(torch.rand(t.shape, generator=g))
    state.opt.step = 7
    return state


def test_port_deploy_checkpoint_loads_in_jax(world, tmp_path):
    _, cfg, params = world
    state = _port_state(cfg, params)
    saver = checkpoint.ModelSaver(str(tmp_path), async_write=True)
    path = saver.save(3, to_jax_flat(model_state(state.model)))
    checkpoint.drain_writes()
    assert path.endswith("model_step_3.npz")
    _assert_trees_equal(j_ckpt.load_tree(path), params)
    with np.load(path) as z:
        merged, report = j_ckpt.load_with_mismatch(params, dict(z))
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    assert j_ckpt.ModelSaver(str(tmp_path)).available_steps() == [3]


def test_port_bundle_resumes_in_jax(world, tmp_path):
    """The JAX trainer's resume reads the port's bundle: the global step,
    the weights, the update count and moments over every leaf of its
    parameter tree (zeros where a leaf does not train)."""
    _, cfg, params = world
    state = _port_state(cfg, params)
    restorer = checkpoint.TrainingRestorer(str(tmp_path), save_steps=1,
                                           async_write=True)
    restorer.save(11, trainer.restore_bundle(state))
    checkpoint.drain_writes()
    step, tree = j_ckpt.TrainingRestorer(str(tmp_path), 1).restore()
    assert step == 11
    _assert_trees_equal(tree["params"], params)
    assert int(tree["opt"]["step"]) == 7
    jstate = j_optim.AdamWState(np.int32(tree["opt"]["step"]),
                                tree["opt"]["mu"], tree["opt"]["nu"])
    want_mu = to_jax_flat({n: state.opt.mu.get(n, torch.zeros_like(t))
                           for n, t in model_state(state.model).items()})
    got_mu = _flat(jstate.mu)
    assert set(got_mu) == set(_flat(params))
    for k, v in want_mu.items():
        np.testing.assert_array_equal(got_mu[k], v, err_msg=k)
        if "/bn/" in k:
            assert not got_mu[k].any()


def test_jax_bundle_resumes_in_the_port(world, tmp_path):
    jcfg, cfg, params = world
    rng = np.random.default_rng(9)
    mu = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                      params)
    nu = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                      params)
    j_ckpt.TrainingRestorer(str(tmp_path), 1).save(
        5, {"params": params,
            "opt": {"step": np.asarray(5, np.int32), "mu": mu, "nu": nu}})
    step, tree = checkpoint.TrainingRestorer(str(tmp_path), 1).restore()
    assert step == 5
    state = _port_state(cfg, params)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)             # every weight differs from the bundle
    trainer.load_bundle(state, tree)
    assert state.opt.step == 5
    bundle = trainer.restore_bundle(state)
    _assert_trees_equal(j_ckpt.unflatten_tree(bundle["params"]), params)
    mu_flat = _flat(mu)
    for k, v in bundle["opt"]["mu"].items():
        if "/bn/" not in k:         # frozen leaves keep no moments here
            np.testing.assert_array_equal(v, mu_flat[k], err_msg=k)
    nu_flat = _flat(nu)
    for k, v in bundle["opt"]["nu"].items():
        if "/bn/" not in k:
            np.testing.assert_array_equal(v, nu_flat[k], err_msg=k)


def test_rotation_and_torn_file_fallback(tmp_path):
    """The restorer's rotation and torn-primary fallback, on a small state
    tree (the bundles above are the real schema)."""
    restorer = checkpoint.TrainingRestorer(str(tmp_path), save_steps=2,
                                           async_write=True)
    assert restorer.restore() is None

    def tree(step):
        return {"params": {"w": np.full((3, 2), step, np.float32)},
                "opt": {"step": np.asarray(step, np.int32)}}

    assert not restorer.step(1, tree(1))
    assert restorer.step(2, tree(2))
    restorer.save(4, tree(4))
    step, got = restorer.restore()
    assert step == 4 and int(got["opt"]["step"]) == 4
    assert os.path.exists(restorer.backup_path)
    with open(restorer.restore_path, "wb") as f:     # torn primary
        f.write(b"PK\x03\x04 not a whole zip")
    step, got = restorer.restore()
    assert step == 2 and np.array_equal(got["params"]["w"], tree(2)[
        "params"]["w"])
    # the JAX restorer falls back the same way on the same files
    assert j_ckpt.TrainingRestorer(str(tmp_path), 2).restore()[0] == 2


def test_async_write_errors_surface(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    saver = checkpoint.ModelSaver(str(tmp_path), async_write=True)
    saver.output_dir = str(blocker)         # a directory that cannot exist
    saver.save(1, {"a": np.zeros(3, np.float32)})
    with pytest.raises(OSError):
        checkpoint.drain_writes()
    checkpoint.drain_writes()               # reported once, then clear


def test_setup_model_loads_a_jax_npz(world, tmp_path):
    jcfg, cfg, params = world
    path = tmp_path / "e2e.npz"
    j_ckpt.save_tree(str(path), params)
    run = RunConfig(model_config="", e2e_weights_path=str(path),
                    device="cpu")
    model = trainer.setup_model(run, cfg, "retrieval", "cpu")
    _assert_trees_equal(j_ckpt.unflatten_tree(
        to_jax_flat(model_state(model))), params)
    for bad in ("ref.pt", str(tmp_path / "flat_torch_keys.npz")):
        np.savez(str(tmp_path / "flat_torch_keys.npz"),
                 **{"cnn.backbone.stem.conv1.weight": np.zeros(3)})
        run = RunConfig(model_config="", e2e_weights_path=bad,
                        device="cpu")
        with pytest.raises(NotImplementedError, match="item 4"):
            trainer.setup_model(run, cfg, "retrieval", "cpu")
