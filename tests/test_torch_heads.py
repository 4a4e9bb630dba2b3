"""Every task head of the port against the JAX package's, on the CPU:
``clipbert_forward`` per head (with a group fan-out for seq_cls), the tied
MLM decoder of the pretrain head, the per-element losses, and strict
weight loading for every head. Weights cross with ckpt/from_jax.py;
inputs come from numpy.

Tolerance: rtol 2e-4, atol 2e-5 on fp32 logits and losses, the bound of
tests/test_torch_eval.py (fp32 sums in another order through a 2-layer
BERT and ResNet-50)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert

TOL = dict(rtol=2e-4, atol=2e-5)
HEADS = ("pretrain", "seq_cls", "multi_choice", "regression", "retrieval")
MODEL_KW = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8, num_labels=3,
                loss_type="ce")
IMG, LT = 64, 7


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes gain nothing from a full intra-op pool; two threads
    keep these tests from crowding the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_params(jcfg, head, seed):
    """A JAX parameter tree for ``head`` filled from numpy (the structure
    of clipbert_tpu's init_clipbert via eval_shape), with non-zero biases,
    non-trivial LayerNorm and BN, and positive BN variances."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] == "kernel" and len(s.shape) == 4:
            kh, kw, _, cout = s.shape
            a = rng.standard_normal(s.shape) * (2.0 / (kh * kw * cout)) ** 0.5
        elif keys[-2:] in (["bn", "scale"], ["bn", "var"]):
            a = 0.5 + rng.random(s.shape)
        elif keys[-2:] == ["ln", "scale"]:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.05 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: j_clipbert.init_clipbert(
        jax.random.key(0), jcfg, head))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def cfgs():
    return JModelConfig(**MODEL_KW), ModelConfig(**MODEL_KW)


def _port(tree, cfg, head):
    model = clipbert.empty_clipbert(cfg, head, device="cpu")
    return load_jax_params(model, tree).eval().requires_grad_(False)


def _batch(rng, B_v, G):
    vis = rng.standard_normal((B_v, 1, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, MODEL_KW["vocab_size"], (B_v * G, LT))
    mask = np.ones((B_v * G, LT), np.int64)
    mask[:, 5:] = 0
    mask[-1, 3:] = 0
    return vis, ids, mask


@pytest.mark.parametrize("head,group_size", [
    ("seq_cls", 1), ("seq_cls", 3), ("multi_choice", 1), ("regression", 1),
    ("retrieval", 2), ("pretrain", 1), ("pretrain", 2)])
def test_clipbert_forward_matches_jax(cfgs, rng_np, head, group_size):
    """Each head's outputs on the same pixels and texts; with a group
    size G each visual feeds the G texts that follow it."""
    jcfg, cfg = cfgs
    params = random_params(jcfg, head, 1)
    vis, ids, mask = _batch(rng_np, 2, group_size)
    want = j_clipbert.clipbert_forward(
        params, jcfg, {"visual_inputs": jnp.asarray(vis),
                       "text_input_ids": jnp.asarray(ids, jnp.int32),
                       "text_input_mask": jnp.asarray(mask, jnp.int32)},
        head, compute_dtype=jnp.float32, group_size=group_size)
    model = _port(params, cfg, head)
    got = clipbert.clipbert_forward(
        model, cfg, {"visual_inputs": torch.from_numpy(vis),
                     "text_input_ids": torch.from_numpy(ids),
                     "text_input_mask": torch.from_numpy(mask)},
        head, compute_dtype=torch.float32, group_size=group_size)
    keys = (("mlm_scores", "itm_scores") if head == "pretrain"
            else ("logits",))
    assert set(got) == set(keys) | {"pooled_output"}
    for k in keys + ("pooled_output",):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    width = {"pretrain": None, "multi_choice": 1, "regression": 1}.get(
        head, cfg.num_labels)
    if width:
        assert tuple(got["logits"].shape) == (2 * group_size, width)
    else:
        assert tuple(got["mlm_scores"].shape) == (2 * group_size, LT,
                                                  cfg.vocab_size)


def test_pretrain_decoder_is_the_word_embedding(cfgs):
    """The MLM decoder weight is the word-embedding Parameter itself: one
    tensor, no copy among the parameters, filled by the embedding's leaf,
    and a change to it is seen by the MLM scores."""
    jcfg, cfg = cfgs
    params = random_params(jcfg, "pretrain", 2)
    model = _port(params, cfg, "pretrain")
    tp = model.transformer
    emb = tp.bert.embeddings.word_embeddings.weight
    assert tp.mlm_decoder_weight is emb
    tables = [n for n, p in model.named_parameters()
              if tuple(p.shape) == tuple(emb.shape)]
    assert tables == ["transformer.bert.embeddings.word_embeddings.weight"]
    np.testing.assert_array_equal(
        emb.detach().numpy(),
        params["transformer"]["bert"]["embeddings"]["word_embeddings"])
    seeded = clipbert.init_clipbert(cfg, "pretrain",
                                    generator=torch.Generator().manual_seed(0),
                                    device="cpu")
    assert not seeded.transformer.cls.predictions.bias.any()
    ids = torch.randint(1, cfg.vocab_size, (2, LT))
    ids[ids == 5] = 6          # token 5 only as a decoder row, not an input
    batch = {"text_input_ids": ids,
             "text_input_mask": torch.ones(2, LT, dtype=torch.int64)}
    feats = torch.randn(2, 1, 1, 1, cfg.hidden_size)

    def scores():
        return clipbert.clipbert_forward(
            model, cfg, batch, "pretrain", compute_dtype=torch.float32,
            visual_features=feats)["mlm_scores"]

    before = scores()
    with torch.no_grad():
        emb[5] += 1.0
    after = scores()
    changed = (before != after).any(dim=(0, 1))
    assert changed[5] and changed.sum() == 1


def _np_loss(fn, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


@pytest.mark.parametrize("case", ["ce", "ce_ignore", "bce", "mse",
                                  "cls_ce", "cls_bce", "cls_mse", "rank",
                                  "pretrain"])
def test_losses_match_jax(rng_np, case):
    logits = rng_np.standard_normal((6, 4)).astype(np.float32) * 3
    labels = rng_np.integers(0, 4, 6)
    if case == "ce":
        want = _np_loss(j_clipbert.cross_entropy, logits, labels)
        got = clipbert.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    elif case == "ce_ignore":
        labels[[1, 4]] = -100
        want = _np_loss(j_clipbert.cross_entropy, logits, labels,
                        ignore_index=-100)
        got = clipbert.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     ignore_index=-100)
        assert got[1] == 0 and got[4] == 0
    elif case == "bce":
        targets = rng_np.random((6, 4)).astype(np.float32)
        want = _np_loss(j_clipbert.bce_with_logits, logits, targets)
        got = clipbert.bce_with_logits(torch.from_numpy(logits),
                                       torch.from_numpy(targets))
    elif case == "mse":
        y = rng_np.standard_normal(6).astype(np.float32)
        want = _np_loss(j_clipbert.mse, logits[:, :1], y)
        got = clipbert.mse(torch.from_numpy(logits[:, :1]),
                           torch.from_numpy(y))
    elif case.startswith("cls_"):
        loss_type = {"cls_ce": "ce", "cls_bce": "bce", "cls_mse": "ce"}[case]
        n = 1 if case == "cls_mse" else 4
        jcfg = JModelConfig(num_labels=n, loss_type=loss_type)
        cfg = ModelConfig(num_labels=n, loss_type=loss_type)
        lg = logits[:, :n]
        y = (rng_np.random((6, 4)).astype(np.float32) if case == "cls_bce"
             else labels if case == "cls_ce"
             else rng_np.standard_normal(6).astype(np.float32))
        want = np.asarray(j_clipbert.classification_loss(
            jcfg, jnp.asarray(lg), jnp.asarray(y)))
        got = clipbert.classification_loss(cfg, torch.from_numpy(lg),
                                           torch.from_numpy(y))
    elif case == "rank":
        want = _np_loss(j_clipbert.retrieval_rank_loss, logits[:, :1],
                        sample_size=2, margin=0.2)
        got = clipbert.retrieval_rank_loss(torch.from_numpy(logits[:, :1]),
                                           2, 0.2)
    else:
        V = 9
        out = {"mlm_scores": rng_np.standard_normal((2, 3, V)).astype(
                   np.float32),
               "itm_scores": rng_np.standard_normal((2, 2)).astype(
                   np.float32)}
        mlm = rng_np.integers(0, V, (2, 3))
        mlm[0, 1] = -100
        itm = rng_np.integers(0, 2, 2)
        jcfg, cfg = JModelConfig(vocab_size=V), ModelConfig(vocab_size=V)
        jw = j_clipbert.pretrain_losses(
            jcfg, {k: jnp.asarray(v) for k, v in out.items()},
            jnp.asarray(mlm), jnp.asarray(itm))
        gw = clipbert.pretrain_losses(
            cfg, {k: torch.from_numpy(v) for k, v in out.items()},
            torch.from_numpy(mlm), torch.from_numpy(itm))
        assert set(gw) == set(jw) == {"mlm_loss", "itm_loss"}
        for k in jw:
            np.testing.assert_allclose(gw[k].numpy(), np.asarray(jw[k]),
                                       **TOL)
        only_itm = clipbert.pretrain_losses(
            cfg, {k: torch.from_numpy(v) for k, v in out.items()}, None,
            torch.from_numpy(itm))
        assert set(only_itm) == {"itm_loss"}
        return
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("head", HEADS)
def test_load_jax_params_is_strict_for_every_head(cfgs, head):
    """Every leaf of each head's JAX tree fills one port tensor and every
    port tensor is filled; a missing or an extra leaf raises. The tied
    decoder has no leaf of its own."""
    jcfg, cfg = cfgs
    params = random_params(jcfg, head, 3)
    model = _port(params, cfg, head)
    tp = params["transformer"]
    for name, leaf in (("classifier", ("fc2", "kernel")),
                       ("regressor", ("bn", "var")),
                       ("cls", ("predictions", "bias"))):
        if name in tp:
            got = dict(model.named_parameters(), **dict(
                model.named_buffers()))[
                f"transformer.{name}.{'.'.join(leaf)}".replace(
                    "kernel", "weight")]
            want = np.asarray(tp[name][leaf[0]][leaf[1]])
            np.testing.assert_array_equal(
                got.numpy(), want.T if leaf[1] == "kernel" else want)
    head_key = next(k for k in tp if k != "bert")
    missing = dict(params, transformer={k: v for k, v in tp.items()
                                        if k != head_key})
    with pytest.raises(KeyError):
        load_jax_params(clipbert.empty_clipbert(cfg, head, device="cpu"),
                        missing)
    other = "regression" if head != "regression" else "seq_cls"
    with pytest.raises(KeyError):
        load_jax_params(clipbert.empty_clipbert(cfg, other, device="cpu"),
                        params)
