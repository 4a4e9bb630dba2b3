"""The CNN's two kernels in the port (ops/matmul_bn_act.py,
ops/fused_stem_pool.py) and the kernel form of ResNet-50 against the JAX
package's Pallas kernels, on the CPU: JAX runs its kernels in interpret
mode (as tests/test_pallas_kernels.py does), the port's wrappers take their
plain versions because the tensors lie on the CPU. Inputs come from numpy.

Tolerances: 2e-5 for the fused 1x1 GEMM (the JAX test's own,
tests/test_pallas_kernels.py:23), 1e-4 for the stem (:70-71), and for the
whole ResNet-50 1e-4 with folded BN (:84-85) and 1e-3 unfolded (:47-48),
relative to the largest output: fp32 sums taken in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.models import resnet as j_resnet
from clipbert_tpu.ops import pallas_kernels as j_pk
from clipbert_tpu.ops import pallas_stem as j_stem
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.models import resnet
from clipbert_tpu_torch.ops import fused_stem_pool as fsp
from clipbert_tpu_torch.ops import matmul_bn_act as mba

GEMM_TOL = dict(rtol=2e-5, atol=2e-5)
STEM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes gain nothing from a full intra-op pool; two threads
    keep these tests from crowding the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("residual,relu", [(True, True), (False, False),
                                           (False, True), (True, False)])
def test_matmul_bn_act_matches_jax(rng_np, residual, relu):
    x = rng_np.standard_normal((100, 64)).astype(np.float32)
    w = (rng_np.standard_normal((64, 96)) * 0.1).astype(np.float32)
    s = rng_np.standard_normal(96).astype(np.float32)
    b = rng_np.standard_normal(96).astype(np.float32)
    r = rng_np.standard_normal((100, 96)).astype(np.float32)
    want = j_pk.matmul_bn_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              jnp.asarray(b),
                              residual=jnp.asarray(r) if residual else None,
                              relu=relu)
    got = mba.matmul_bn_act(_t(x), _t(w), _t(s), _t(b),
                            residual=_t(r) if residual else None, relu=relu)
    assert tuple(got.shape) == (100, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    assert mba.LAUNCHES == 0                # the CPU takes the plain version


def test_matmul_bn_act_folded_scale_is_none(rng_np):
    """scale=None (BN folded into w) equals an all-ones scale."""
    x = _t(rng_np.standard_normal((37, 24)))
    w = _t(rng_np.standard_normal((24, 40)) * 0.1)
    b = _t(rng_np.standard_normal(40))
    np.testing.assert_array_equal(
        mba.matmul_bn_act(x, w, None, b).numpy(),
        mba.matmul_bn_act(x, w, torch.ones(40), b).numpy())


@pytest.mark.parametrize("residual", [False, True])
def test_conv1x1_strided_matches_jax(rng_np, residual):
    x = rng_np.standard_normal((2, 7, 8, 16)).astype(np.float32)
    k = (rng_np.standard_normal((1, 1, 16, 32)) * 0.1).astype(np.float32)
    s = (0.5 + rng_np.random(32)).astype(np.float32)
    b = rng_np.standard_normal(32).astype(np.float32)
    r = rng_np.standard_normal((2, 4, 4, 32)).astype(np.float32)
    want = j_pk.conv1x1_bn_act(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(s), jnp.asarray(b), stride=2,
                               residual=jnp.asarray(r) if residual else None,
                               relu=False)
    # the port's conv weight is OIHW
    got = mba.conv1x1_bn_act(_t(x), _t(k.transpose(3, 2, 0, 1)), _t(s),
                             _t(b), stride=2,
                             residual=_t(r) if residual else None,
                             relu=False)
    assert tuple(got.shape) == (2, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_matmul_bn_act_rejects_bad_operands():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        mba.matmul_bn_act(x, torch.zeros(9, 3), None, torch.zeros(3))
    with pytest.raises(ValueError):
        mba.matmul_bn_act(x, torch.zeros(8, 3), None, torch.zeros(3),
                          residual=torch.zeros(4, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        mba.matmul_bn_act(x.half(), torch.zeros(8, 3), None, torch.zeros(3))
    # the weight's device is checked with the other operands'
    with pytest.raises(ValueError, match="different devices"):
        mba.matmul_bn_act(x, torch.zeros(8, 3, device="meta"), None,
                          torch.zeros(3))
    with pytest.raises(ValueError, match="different devices"):
        mba.conv1x1_bn_act(x.reshape(1, 2, 2, 8),
                           torch.zeros(3, 8, 1, 1, device="meta"), None,
                           torch.zeros(3))


def _stem_inputs(rng_np, shape):
    x = rng_np.standard_normal(shape).astype(np.float32)
    k = (rng_np.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    scale = (0.5 + rng_np.random(64)).astype(np.float32)
    bias = rng_np.standard_normal(64).astype(np.float32)
    return x, k, scale, bias


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 48, 80, 3),
                                   (2, 32, 32, 3)])
def test_fused_stem_pool_matches_jax(rng_np, shape):
    x, k, scale, bias = _stem_inputs(rng_np, shape)
    wp = jnp.asarray(j_stem.pack_stem_weights(k, scale))
    want = j_stem.fused_stem_pool(jnp.asarray(x), wp, jnp.asarray(bias))
    folded = k.transpose(3, 2, 0, 1) * scale[:, None, None, None]
    got = fsp.fused_stem_pool(_t(x), _t(folded), _t(bias))
    assert tuple(got.shape) == (shape[0], shape[1] // 4, shape[2] // 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEM_TOL)
    assert fsp.LAUNCHES == 0


@pytest.mark.parametrize("shape", [(1, 37, 53, 3), (1, 9, 5, 3)])
def test_fused_stem_pool_odd_sizes_match_jax_stem(rng_np, shape):
    """Sizes the TPU kernel does not take (H, W not multiples of 16): the
    port's kernel takes them, and its plain version equals the JAX
    package's XLA stem (conv, BN, ReLU, -inf padded maxpool)."""
    x, k, scale, bias = _stem_inputs(rng_np, shape)
    h = j_resnet.conv2d(jnp.asarray(x), jnp.asarray(k), 2, [(3, 3), (3, 3)])
    h = jax.nn.relu(h * scale + bias)
    want = j_resnet.max_pool(h, 3, 2, [(0, 0), (1, 1), (1, 1), (0, 0)])
    folded = k.transpose(3, 2, 0, 1) * scale[:, None, None, None]
    got = fsp.fused_stem_pool(_t(x), _t(folded), _t(bias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEM_TOL)


def _resnet_params(seed):
    """A JAX ResNet-50 tree filled from numpy: He-normal convs, non-trivial
    frozen BN (scale in [0.5, 1.5), small biases)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] == "kernel":
            kh, kw, _, cout = s.shape
            a = rng.standard_normal(s.shape) * (2.0 / (kh * kw * cout)) ** 0.5
        elif keys[-1] == "scale":
            a = 0.5 + rng.random(s.shape)
        else:
            a = 0.05 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: j_resnet.init_resnet50(jax.random.key(0)))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_resnet(tree):
    with torch.device("meta"):
        m = resnet.ResNet50()
    return load_jax_params(m.to_empty(device="cpu"), tree).requires_grad_(
        False)


@pytest.fixture(scope="module")
def r50():
    p = _resnet_params(7)
    folded = jax.tree.map(np.asarray, j_resnet.fold_bn_scales(p))
    return {"unfolded": (p, _port_resnet(p)),
            "folded": (folded, _port_resnet(folded))}


@pytest.mark.parametrize("which,tol", [("folded", 1e-4), ("unfolded", 1e-3)])
def test_resnet50_kernel_form_matches_jax_pallas(r50, rng_np, which, tol):
    tree, port = r50[which]
    x = rng_np.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: j_resnet.resnet50_forward(
        p, x, use_pallas=True))(tree, jnp.asarray(x))
    got = resnet.resnet50_forward(port, _t(x), use_kernels=True).numpy()
    assert got.shape == (1, 2, 2, 2048)
    # res5 outputs reach ~100 with these weights: the bound is taken
    # relative to the largest output, as the JAX test's outputs are O(1)
    m = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / m, np.asarray(want) / m, rtol=tol,
                               atol=tol)
    # and the cuDNN form, which the CPU default takes, agrees with it
    plain = resnet.resnet50_forward(port, _t(x)).numpy()
    np.testing.assert_allclose(plain / m, got / m, rtol=tol, atol=tol)
    assert mba.LAUNCHES == 0 and fsp.LAUNCHES == 0
