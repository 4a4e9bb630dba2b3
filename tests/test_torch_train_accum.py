"""Gradient accumulation: the port's make_train_step at accum 2 on two
half-size micro-batches against the JAX package's (compiled once), on the
retrieval head with mean pooling and CE; and the port's accum-2 update
against its own accum-1 update on the whole batch (equal-size micro-batches
average to the whole batch's mean loss). Sizes and tolerances as in
tests/test_torch_train_step.py."""

import numpy as np
import pytest
import torch

from clipbert_tpu.core.config import ModelConfig as JModelConfig
from test_torch_train_step import (B_V, CNN_MOMENT_REL, LOSS_TOL, MODEL_KW,
                                   MOMENT_TOL, check_against_jax, jax_step,
                                   make_batch, port_step, random_params)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    params = random_params(JModelConfig(**MODEL_KW), "retrieval", 1)
    whole = make_batch(np.random.default_rng(1), B_V)
    half = B_V // 2
    groups = 2 * half                   # texts per micro-batch (group 2)
    micros = [{k: (v[i * half:(i + 1) * half] if k == "visual_inputs"
                   else v[i * groups:(i + 1) * groups])
               for k, v in whole.items()} for i in range(2)]
    stacked = {k: np.stack([m[k] for m in micros]) for k in whole}
    return params, whole, stacked, port_step(params, stacked, "mean", 2)


def test_accum_2_matches_jax(world):
    params, _, stacked, accum_2 = world
    check_against_jax(jax_step(params, stacked, "mean", 2), accum_2, params)


def test_accum_2_equals_accum_1_on_the_whole_batch(world):
    params, whole, _, (m2, _, s2) = world
    m1, _, s1 = port_step(params, whole, "mean", 1)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), **LOSS_TOL)
    for n, t in s2.opt.mu.items():
        want = s1.opt.mu[n].numpy()
        tol = (dict(rtol=0, atol=CNN_MOMENT_REL * np.abs(want).max())
               if n.startswith("cnn.") else MOMENT_TOL)
        np.testing.assert_allclose(t.numpy(), want, err_msg=n, **tol)
