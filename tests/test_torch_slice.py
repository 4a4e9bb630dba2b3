"""The port's retrieval serving slice against the JAX package's, on the
CPU: the scoring program, the device preprocess, the whole RetrievalScorer
and its HTTP endpoint. Weights cross with clipbert_tpu_torch/ckpt/
from_jax.py; inputs come from numpy."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import save_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.data import transforms as j_transforms
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.serve import RetrievalScorer as JRetrievalScorer
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import tokenization, transforms, video
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.serve import RetrievalScorer, make_http_server
from clipbert_tpu_torch.train import steps


def random_params(jcfg, seed):
    """A JAX parameter tree for head ``retrieval`` filled from numpy (the
    structure of clipbert_tpu's init_clipbert via eval_shape), with
    non-zero biases and non-trivial LayerNorm and frozen BN."""
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
    return load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"), tree)


def test_text_prob_step_matches_jax_fused(rng_np):
    """make_text_prob_step on cached features against the JAX step with
    fused_attn=True, at the config, shapes and tolerance of
    tests/test_pallas_kernels.py:124-155."""
    kw = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_grid_row_position_embeddings=8,
              max_grid_col_position_embeddings=8, num_labels=2)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params = random_params(jcfg, 1)
    feats = (rng_np.standard_normal((2, 2, 1, 3, 3, 32)) * 0.1).astype(
        np.float32)
    ids = rng_np.integers(0, 64, (5, 7))
    mask = np.ones((5, 7), np.int64)
    mask[:, 5:] = 0
    jts = j_steps.TaskSettings(head_type="retrieval", num_labels=2,
                               loss_type="ce", score_agg_func="lse",
                               train_n_clips=2, group_size=1)
    want = np.asarray(j_steps.make_text_prob_step(
        jcfg, jts, jnp.float32, fused_attn=True)(
        params, jnp.asarray(feats), jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32)))
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse")
    model = _port(params, cfg)
    for fused in (True, False, None):
        got = steps.make_text_prob_step(cfg, ts, torch.float32,
                                        fused_attn=fused)(
            model, torch.from_numpy(feats), torch.from_numpy(ids),
            torch.from_numpy(mask))
        assert tuple(got.shape) == (2, 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_resize_pad_normalize_matches_jax(rng_np, exact):
    """Two items of different native sizes in one 64 px bucket. exact=True
    is fp32 on both sides (1e-4 on values of magnitude ~130). exact=False
    rounds the row product to bf16 on both sides; a sum taken in another
    order can flip that rounding by one bf16 ulp (<= 1 unit at pixel
    values <= 255), so the bound is one pixel unit."""
    frames = rng_np.integers(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)
    src_hw = np.array([[48, 64, 36, 48], [64, 40, 48, 30]], np.int64)
    want = np.asarray(j_transforms.resize_pad_normalize(
        jnp.asarray(frames), jnp.asarray(src_hw, jnp.int32), 48,
        compute_dtype=jnp.float32, exact=exact))
    got = transforms.resize_pad_normalize(
        torch.from_numpy(frames), torch.from_numpy(src_hw), 48,
        compute_dtype=torch.float32, exact=exact).numpy()
    assert got.shape == (2, 2, 48, 48, 3)
    tol = dict(rtol=0, atol=1e-4) if exact else dict(rtol=0, atol=1.0)
    np.testing.assert_allclose(got, want, **tol)
    assert np.abs(got - want).mean() < (1e-5 if exact else 1e-2)
    # the pad region (rows/cols past the resize target) is -mean exactly
    assert np.allclose(got[1, :, :, 30:], -np.array(
        transforms.IMAGENET_MEAN_255, np.float32))


N_CLIPS, NUM_FRM, IMG = 2, 2, 64
CAPS = ["a cat runs", "the dog", "a dog"]


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    """The JAX and the port scorer on the same weights, JSEQ blob, config and
    fp32 dtype as tests/test_serve.py:33-55."""
    tok_dir = tmp_path_factory.mktemp("serve_torch")
    vocab = tok_dir / "vocab.txt"
    tokenization.write_tiny_vocab(
        str(vocab), extra_tokens=["cat", "dog", "runs", "a", "the"])
    tok = tokenization.BertTokenizer(str(vocab))
    kw = dict(vocab_size=len(tok), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=64, max_grid_row_position_embeddings=4,
              max_grid_col_position_embeddings=4, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0, num_labels=2, loss_type="ce",
              score_agg_func="lse")
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params = random_params(jcfg, 5)
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 255, (12, 48, IMG, 3)).astype(np.uint8)
    blob = video.encode_jseq_from_array(frames, fps=8)
    common = dict(num_frm=NUM_FRM, n_clips=N_CLIPS, fps=4, max_img_size=IMG,
                  max_txt_len=8, max_captions=8)
    jsc = JRetrievalScorer(params, jcfg, tok, compute_dtype=jnp.float32,
                           **common)
    sc = RetrievalScorer(_port(params, cfg), cfg, tok, device="cpu",
                         compute_dtype=torch.float32, **common)
    return {"jax": jsc, "port": sc, "blob": blob, "params": params,
            "cfg": cfg, "tok_dir": tok_dir, "common": common}


def test_scorer_matches_jax_scorer(scorers):
    blob = scorers["blob"]
    want = scorers["jax"].score(blob, CAPS)
    got = scorers["port"].score(blob, CAPS)
    assert got.shape == (3,)
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_scorer_bucket_independent(scorers):
    """Padding captions to the bucket must not change real scores, cached
    features reproduce the bytes path, bad requests raise ValueError
    (as tests/test_serve.py:88-105 checks the JAX scorer)."""
    sc, blob = scorers["port"], scorers["blob"]
    p3 = sc.score(blob, CAPS)                          # bucket 4
    p5 = sc.score(blob, CAPS + ["cat", "the cat"])     # bucket 8
    np.testing.assert_allclose(p3, p5[:3], rtol=1e-5, atol=1e-6)
    feats = sc.encode_video(blob)
    assert tuple(feats.shape) == (1, N_CLIPS, NUM_FRM, 1, 1, 32)
    np.testing.assert_allclose(sc.score(None, CAPS, features=feats), p3,
                               rtol=1e-6)
    frames = sc._decode_clips(blob)
    np.testing.assert_array_equal(sc.encode_frames(frames).numpy(),
                                  feats.numpy())
    with pytest.raises(ValueError):
        sc.score(blob, ["x"] * 9)                      # > max_captions
    with pytest.raises(ValueError):
        sc.encode_video(b"not a video")
    assert fa.LAUNCHES == 0                            # CPU: plain version


def test_http_score_round_trip(scorers):
    sc, blob = scorers["port"], scorers["blob"]
    server = make_http_server(sc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/score"

        def post(payload):
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        code, out = post({"video_b64": base64.b64encode(blob).decode(),
                          "captions": CAPS})
        assert code == 200
        np.testing.assert_allclose(out["probs"], sc.score(blob, CAPS),
                                   rtol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"captions": CAPS})                   # no video
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_from_checkpoint_loads_a_jax_deploy_npz(scorers, tmp_path):
    """The serve CLI's load path: a deploy .npz written by the JAX
    package's own checkpoint writer, through the weight bridge."""
    ckpt = tmp_path / "model_step_1.npz"
    save_tree(str(ckpt), scorers["params"])
    cfg_json = tmp_path / "model_config.json"
    cfg_json.write_text(json.dumps(scorers["cfg"].to_dict()))
    loaded = RetrievalScorer.from_checkpoint(
        str(cfg_json), str(scorers["tok_dir"]), str(ckpt), device="cpu",
        compute_dtype=torch.float32, **scorers["common"])
    blob = scorers["blob"]
    np.testing.assert_array_equal(loaded.score(blob, CAPS),
                                  scorers["port"].score(blob, CAPS))
    with pytest.raises(ValueError):
        RetrievalScorer.from_checkpoint(
            str(cfg_json), str(scorers["tok_dir"]), str(tmp_path / "x.pt"),
            device="cpu")
