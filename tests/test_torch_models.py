"""Parity of the port's models (clipbert_tpu_torch/models) with the JAX
package's, on the CPU, with the JAX weights carried across by
clipbert_tpu_torch/ckpt/from_jax.py.

Tolerances: 1e-3 for the ResNet (the tolerance tests/test_pallas_kernels.py
:47-48 uses for this 50-layer network in fp32), 1e-5 for BERT (fp32 sums in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import flatten_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.models import bert as j_bert
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.models import resnet as j_resnet
from clipbert_tpu.models import visual_embed as j_visual
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import bert, clipbert, resnet, visual_embed

CNN_TOL = dict(rtol=1e-3, atol=1e-3)
BERT_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, max_grid_row_position_embeddings=8,
           max_grid_col_position_embeddings=8, num_labels=2)


def random_params(jcfg, seed):
    """A JAX parameter tree for head ``retrieval`` filled from numpy: the
    structure of clipbert_tpu's init_clipbert (via eval_shape, no compute),
    non-zero biases, non-trivial LayerNorm and frozen BN."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] == "kernel" and len(s.shape) == 4:
            kh, kw, _, cout = s.shape
            a = rng.standard_normal(s.shape) * (2.0 / (kh * kw * cout)) ** 0.5
        elif keys[-2:] == ["bn", "scale"]:
            a = 0.5 + rng.random(s.shape)
        elif keys[-2:] == ["ln", "scale"]:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.05 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: j_clipbert.init_clipbert(
        jax.random.key(0), jcfg, "retrieval"))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(tree, cfg):
    """The port's model filled from a JAX tree (allocated, not initialized:
    the bridge writes every tensor)."""
    model = clipbert.empty_clipbert(cfg, device="cpu")
    return load_jax_params(model, tree).requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JModelConfig(**CFG), ModelConfig(**CFG)
    params = random_params(jcfg, 4)
    folded = jax.tree.map(np.asarray, j_clipbert.fold_cnn_bn_scales(params))
    return {"jcfg": jcfg, "cfg": cfg, "params": params, "folded": folded,
            "port": _port(params, cfg), "port_folded": _port(folded, cfg)}


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("which", ["folded", "unfolded"])
def test_resnet50_forward_matches_jax(models, rng_np, which):
    key = "folded" if which == "folded" else "params"
    port = models["port_folded" if which == "folded" else "port"]
    x = rng_np.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(j_resnet.resnet50_forward)(models[key]["cnn"]["resnet"],
                                              jnp.asarray(x))
    got = resnet.resnet50_forward(port.cnn.resnet, torch.from_numpy(x))
    assert tuple(got.shape) == (1, 2, 2, 2048)
    np.testing.assert_allclose(got.numpy(), _np(want), **CNN_TOL)


def test_grid_feat_forward_matches_jax(models, rng_np):
    x = rng_np.standard_normal((1, 2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(j_resnet.grid_feat_forward)(models["folded"]["cnn"],
                                               jnp.asarray(x))
    got = resnet.grid_feat_forward(models["port_folded"].cnn,
                                   torch.from_numpy(x))
    assert tuple(got.shape) == (1, 2, 1, 1, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), **CNN_TOL)


def test_port_fold_matches_jax_fold(models, rng_np):
    """Loading the unfolded tree and folding in the port equals loading the
    JAX-folded tree."""
    port = _port(models["params"], models["cfg"])
    resnet.fold_bn_scales(port.cnn.resnet)
    x = torch.from_numpy(rng_np.standard_normal((1, 64, 64, 3)).astype(
        np.float32))
    a = resnet.resnet50_forward(port.cnn.resnet, x)
    b = resnet.resnet50_forward(models["port_folded"].cnn.resnet, x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert all(m.scale is None for m in port.modules()
               if isinstance(m, resnet.FrozenBN))


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_matches_jax(models, rng_np, fused):
    hidden = rng_np.standard_normal((5, 9, 32)).astype(np.float32)
    mask = np.ones((5, 9), np.float32)
    mask[:, 7:] = 0.0
    enc = models["params"]["transformer"]["bert"]["encoder"]
    want = j_bert.encoder(enc, jnp.asarray(hidden),
                          j_bert.extended_attention_mask(jnp.asarray(mask)),
                          models["jcfg"], fused_attn=fused)
    got = bert.encoder(models["port"].transformer.bert.encoder,
                       torch.from_numpy(hidden),
                       bert.extended_attention_mask(torch.from_numpy(mask)),
                       models["cfg"], fused_attn=fused)
    np.testing.assert_allclose(got.numpy(), _np(want), **BERT_TOL)


@pytest.mark.parametrize("act", ["swish", "mish"])
def test_encoder_hidden_act_matches_jax(models, rng_np, act):
    """A model config naming ``hidden_act`` swish or mish builds in the
    port and its encoder matches the JAX package's."""
    jcfg = JModelConfig(**dict(CFG, hidden_act=act))
    cfg = ModelConfig(**dict(CFG, hidden_act=act))
    port = _port(models["params"], cfg)
    hidden = rng_np.standard_normal((3, 9, 32)).astype(np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[:, 6:] = 0.0
    enc = models["params"]["transformer"]["bert"]["encoder"]
    want = j_bert.encoder(enc, jnp.asarray(hidden),
                          j_bert.extended_attention_mask(jnp.asarray(mask)),
                          jcfg, fused_attn=False)
    got = bert.encoder(port.transformer.bert.encoder,
                       torch.from_numpy(hidden),
                       bert.extended_attention_mask(torch.from_numpy(mask)),
                       cfg, fused_attn=False)
    np.testing.assert_allclose(got.numpy(), _np(want), **BERT_TOL)


def test_text_embeddings_matches_jax(models, rng_np):
    ids = rng_np.integers(0, 64, (3, 7))
    p = models["params"]["transformer"]["bert"]["embeddings"]
    want = j_bert.text_embeddings(p, jnp.asarray(ids, jnp.int32),
                                  models["jcfg"], jnp.float32)
    got = bert.text_embeddings(models["port"].transformer.bert.embeddings,
                               torch.from_numpy(ids), models["cfg"],
                               torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), **BERT_TOL)


def test_visual_embeddings_matches_jax(models, rng_np):
    grid = rng_np.standard_normal((2, 2, 3, 4, 32)).astype(np.float32)
    p = models["params"]["transformer"]["bert"]["visual_embeddings"]
    want = j_visual.visual_embeddings(p, jnp.asarray(grid), models["jcfg"])
    got = visual_embed.visual_embeddings(
        models["port"].transformer.bert.visual_embeddings,
        torch.from_numpy(grid), models["cfg"])
    assert tuple(got.shape) == (2, 12, 32)
    np.testing.assert_allclose(got.numpy(), _np(want), **BERT_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_base_forward_matches_jax(models, rng_np, fused):
    ids = rng_np.integers(0, 64, (4, 6))
    mask = np.ones((4, 6), np.int64)
    mask[:, 4:] = 0
    grid = rng_np.standard_normal((4, 2, 3, 3, 32)).astype(np.float32) * 0.1
    p = models["params"]["transformer"]["bert"]
    want_h, want_p = j_clipbert.base_forward(
        p, models["jcfg"], jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(grid), jnp.float32, fused_attn=fused)
    got_h, got_p = clipbert.base_forward(
        models["port"].transformer.bert, models["cfg"], torch.from_numpy(ids),
        torch.from_numpy(mask), torch.from_numpy(grid), torch.float32,
        fused_attn=fused)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), **BERT_TOL)
    np.testing.assert_allclose(got_p.numpy(), _np(want_p), **BERT_TOL)


def test_bridge_takes_the_flat_npz_form_and_is_strict(models, rng_np):
    flat = flatten_tree(models["params"])          # deploy .npz keys
    port = _port(flat, models["cfg"])
    x = torch.from_numpy(rng_np.standard_normal((4, 2, 3, 3, 32)).astype(
        np.float32))
    ids = torch.from_numpy(rng_np.integers(0, 64, (4, 6)))
    mask = torch.ones(4, 6, dtype=torch.int64)
    a = clipbert.base_forward(port.transformer.bert, models["cfg"], ids,
                              mask, x, torch.float32)[1]
    b = clipbert.base_forward(models["port"].transformer.bert, models["cfg"],
                              ids, mask, x, torch.float32)[1]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(KeyError):
        load_jax_params(port, {k: v for k, v in flat.items()
                               if not k.endswith("pooler/dense/bias")})
