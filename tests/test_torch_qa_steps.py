"""The port's QA and eval steps against the JAX package's, on the CPU:
``mil_forward`` for the seq_cls and multi_choice heads (the multiple-choice
option fold), ``make_eval_step``, ``make_pretrain_eval_step``,
``make_videoqa_prob_step`` (open-ended and multiple-choice) and
``make_qa_answer_step`` (bce and ce). Weights cross with
ckpt/from_jax.py; inputs come from numpy.

Tolerance: rtol 2e-4, atol 2e-5 on fp32 logits and probabilities, the
bound of tests/test_torch_eval.py; argmax predictions must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.core.rng import RngGen
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.train import steps

TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_KW = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8, loss_type="ce")
IMG, NUM_FRM, LT, N_OPT = 64, 1, 7, 5


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
    of clipbert_tpu's init_clipbert via eval_shape), with non-zero biases
    and non-trivial LayerNorm and BN."""
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


HEADS = {"seq_cls": 6, "multi_choice": N_OPT, "retrieval": 2,
         "pretrain": 2}


@pytest.fixture(scope="module")
def world():
    """Per head: the JAX config, the port config, the JAX tree and the
    port model on it."""
    out = {}
    for i, (head, n) in enumerate(HEADS.items()):
        kw = dict(MODEL_KW, num_labels=n)
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        params = random_params(jcfg, head, 10 + i)
        model = load_jax_params(clipbert.empty_clipbert(cfg, head,
                                                        device="cpu"),
                                params).eval().requires_grad_(False)
        out[head] = (jcfg, cfg, params, model)
    return out


def _texts(rng, n):
    ids = rng.integers(1, MODEL_KW["vocab_size"], (n, LT))
    mask = np.ones((n, LT), np.int64)
    mask[::2, 4:] = 0
    return ids, mask


def _ts(mod, head, n, **kw):
    return mod.TaskSettings(head_type=head, num_labels=n, loss_type="ce",
                            **kw)


def _jbatch(vis, ids, mask):
    return {"visual_inputs": jnp.asarray(vis),
            "text_input_ids": jnp.asarray(ids, jnp.int32),
            "text_input_mask": jnp.asarray(mask, jnp.int32)}


def _tbatch(vis, ids, mask):
    return {"visual_inputs": torch.from_numpy(vis),
            "text_input_ids": torch.from_numpy(ids),
            "text_input_mask": torch.from_numpy(mask)}


@pytest.mark.parametrize("head", ["seq_cls", "multi_choice"])
def test_mil_forward_matches_jax(world, rng_np, head):
    """Two videos x 2 clips. multi_choice: 5 option texts per question,
    one logit each, folded to (n_q, nc, 5); the logits differ from option
    to option and from clip to clip, so a transposed fold cannot pass."""
    jcfg, cfg, params, model = world[head]
    B_v, nc = 2, 2
    G = N_OPT if head == "multi_choice" else 1
    vis = rng_np.standard_normal((B_v, nc * NUM_FRM, IMG, IMG, 3)).astype(
        np.float32)
    ids, mask = _texts(rng_np, B_v * G)
    kw = dict(score_agg_func="mean", train_n_clips=nc, group_size=G)
    want = np.asarray(j_steps.mil_forward(
        params, jcfg, _ts(j_steps, head, HEADS[head], **kw),
        _jbatch(vis, ids, mask), RngGen(None), False, jnp.float32))
    got = steps.mil_forward(model, cfg, _ts(steps, head, HEADS[head], **kw),
                            _tbatch(vis, ids, mask), torch.float32).numpy()
    assert got.shape == ((B_v, nc, N_OPT) if head == "multi_choice"
                         else (B_v, nc, HEADS[head]))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(np.diff(got, axis=1)).min() > 1e-6       # clips differ
    if head == "multi_choice":
        assert np.abs(np.diff(got, axis=2)).min() > 1e-6   # options differ
        # option o of question q at clip c is the plain forward of clip c
        # of video q with text q * 5 + o
        q, c, o = 1, 1, 3
        one = clipbert.clipbert_forward(
            model, cfg, _tbatch(vis[q:q + 1, c * NUM_FRM:(c + 1) * NUM_FRM],
                                ids[q * G + o:q * G + o + 1],
                                mask[q * G + o:q * G + o + 1]),
            head, compute_dtype=torch.float32)["logits"]
        np.testing.assert_allclose(got[q, c, o], one[0, 0].item(), **TOL)


@pytest.mark.parametrize("head,agg,fused", [
    ("seq_cls", "mean", None), ("seq_cls", "lse", True),
    ("multi_choice", "max", None), ("retrieval", "lse", False)])
def test_make_eval_step_matches_jax(world, rng_np, head, agg, fused):
    jcfg, cfg, params, model = world[head]
    nc = 2
    G = N_OPT if head == "multi_choice" else 1
    vis = rng_np.standard_normal((3, nc * NUM_FRM, IMG, IMG, 3)).astype(
        np.float32)
    ids, mask = _texts(rng_np, 3 * G)
    kw = dict(score_agg_func=agg, train_n_clips=nc, group_size=G)
    want = j_steps.make_eval_step(jcfg, _ts(j_steps, head, HEADS[head], **kw),
                                  jnp.float32)(params,
                                               _jbatch(vis, ids, mask))
    got = steps.make_eval_step(cfg, _ts(steps, head, HEADS[head], **kw),
                               torch.float32, fused_attn=fused)(
        model, _tbatch(vis, ids, mask))
    assert set(got) == {"clip_logits", "logits"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_array_equal(got["logits"].numpy().argmax(-1),
                                  np.asarray(want["logits"]).argmax(-1))


def test_make_pretrain_eval_step_matches_jax(world, rng_np):
    jcfg, cfg, params, model = world["pretrain"]
    G = 2
    vis = rng_np.standard_normal((2, NUM_FRM, IMG, IMG, 3)).astype(
        np.float32)
    ids, mask = _texts(rng_np, 2 * G)
    mlm = np.full((2 * G, LT), -100)
    mlm[:, 1:3] = rng_np.integers(0, jcfg.vocab_size, (2 * G, 2))
    itm = rng_np.integers(0, 2, 2 * G)
    kw = dict(group_size=G)
    jb = dict(_jbatch(vis, ids, mask), mlm_labels=jnp.asarray(mlm),
              itm_labels=jnp.asarray(itm))
    want = j_steps.make_pretrain_eval_step(
        jcfg, _ts(j_steps, "pretrain", 2, **kw), jnp.float32)(params, jb)
    tb = dict(_tbatch(vis, ids, mask), mlm_labels=torch.from_numpy(mlm),
              itm_labels=torch.from_numpy(itm))
    got = steps.make_pretrain_eval_step(
        cfg, _ts(steps, "pretrain", 2, **kw), torch.float32)(model, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    no_mlm = steps.make_pretrain_eval_step(
        cfg, _ts(steps, "pretrain", 2, use_mlm=False, **kw),
        torch.float32)(model, tb)
    assert "mlm_loss" not in no_mlm and "itm_loss" in no_mlm


@pytest.mark.parametrize("head,agg", [("seq_cls", "lse"),
                                      ("multi_choice", "mean")])
def test_make_videoqa_prob_step_matches_jax(world, rng_np, head, agg):
    """One cached video of 3 clips: open-ended softmax over the answers for
    4 questions, or the option-block softmax of 2 questions x 5 options."""
    jcfg, cfg, params, model = world[head]
    feats = (rng_np.standard_normal((1, 3, NUM_FRM, 2, 2, 32)) * 0.5
             ).astype(np.float32)
    ids, mask = _texts(rng_np, 2 * N_OPT if head == "multi_choice" else 4)
    kw = dict(score_agg_func=agg, train_n_clips=3)
    want = np.asarray(j_steps.make_videoqa_prob_step(
        jcfg, _ts(j_steps, head, HEADS[head], **kw), jnp.float32)(
        params, jnp.asarray(feats), jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32)))
    for fused in (None, True):
        got = steps.make_videoqa_prob_step(
            cfg, _ts(steps, head, HEADS[head], **kw), torch.float32,
            fused_attn=fused)(model, torch.from_numpy(feats),
                              torch.from_numpy(ids), torch.from_numpy(mask))
        assert tuple(got.shape) == ((2, N_OPT) if head == "multi_choice"
                                    else (4, HEADS[head]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


@pytest.mark.parametrize("loss_type", ["bce", "ce"])
def test_make_qa_answer_step_matches_jax(world, rng_np, loss_type):
    """One cached image fanned out to 3 questions: sigmoid per answer for
    bce, softmax over the answers for ce."""
    jcfg, cfg, params, model = world["seq_cls"]
    feats = (rng_np.standard_normal((1, 1, 2, 2, 32)) * 0.5).astype(
        np.float32)
    ids, mask = _texts(rng_np, 3)
    jts = j_steps.TaskSettings(head_type="seq_cls", num_labels=6,
                               loss_type=loss_type)
    want = np.asarray(j_steps.make_qa_answer_step(jcfg, jts, jnp.float32)(
        params, jnp.asarray(feats), jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32)))
    ts = steps.TaskSettings(head_type="seq_cls", num_labels=6,
                            loss_type=loss_type)
    got = steps.make_qa_answer_step(cfg, ts, torch.float32)(
        model, torch.from_numpy(feats), torch.from_numpy(ids),
        torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, want, **TOL)
    if loss_type == "ce":
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    else:
        assert not np.allclose(got.sum(-1), 1.0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
