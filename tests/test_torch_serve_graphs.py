"""The scorers' per-bucket CUDA graph layer (utils/cuda_graphs.py, serve.py)
on the CPU, where every call runs eagerly: the device preprocess with its
constants made once against the JAX package's, the bucket keys a request
lands on, the cuda_graphs switch, the copies a scorer hands out, the model
guard, concurrent callers against their serial results, and bench_serving's
sustained load. The replays themselves run on the card (chip_smoke.py phase
20)."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipbert_tpu.data import transforms as j_transforms
from clipbert_tpu_torch import bench_serving
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import tokenization, transforms, video
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import linear
from clipbert_tpu_torch.serve import RetrievalScorer, _pow2_bucket
from clipbert_tpu_torch.utils import cuda_graphs

N_CLIPS, NUM_FRM, IMG = 1, 2, 64
CAPS = [f"a person does thing {i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes gain nothing from a full intra-op pool; two threads
    keep these tests from crowding the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("serve_graphs") / "vocab.txt"
    tokenization.write_tiny_vocab(
        str(vocab), extra_tokens=["a", "person", "does", "thing"]
        + [str(i) for i in range(10)])
    return tokenization.BertTokenizer(str(vocab))


def _cfg(tok):
    return ModelConfig(vocab_size=len(tok), hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, max_position_embeddings=64,
                       max_grid_row_position_embeddings=4,
                       max_grid_col_position_embeddings=4, num_labels=2,
                       loss_type="ce", score_agg_func="lse")


def _scorer(tok, **kw):
    cfg = _cfg(tok)
    model = clipbert.init_clipbert(
        cfg, "retrieval", generator=torch.Generator().manual_seed(0),
        device="cpu")
    return RetrievalScorer(model, cfg, tok, device="cpu",
                           compute_dtype=torch.float32, num_frm=NUM_FRM,
                           n_clips=N_CLIPS, fps=4, max_img_size=IMG,
                           max_txt_len=8, max_captions=8, **kw)


@pytest.fixture(scope="module")
def scorer(tok):
    return _scorer(tok)


@pytest.fixture(scope="module")
def blob():
    return bench_serving.make_clip(np.random.default_rng(3), frames=8, h=48,
                                   w=IMG, fps=8)


@pytest.mark.parametrize("exact", [True, False])
def test_device_preprocess_matches_jax(rng_np, exact):
    """device_preprocess and normalize_pixels with the normalization
    constants made once per device, against the JAX package at the bounds
    of tests/test_torch_slice.py::test_resize_pad_normalize_matches_jax
    (1e-4 in fp32; one pixel unit where the row product rounds to bf16).
    A second call reuses the constants and gives the same bits."""
    frames = rng_np.integers(0, 256, (2, 2, 64, 64, 3)).astype(np.uint8)
    src_hw = np.array([[48, 64, 36, 48], [64, 40, 48, 30]], np.int64)
    want = np.asarray(j_transforms.resize_pad_normalize(
        jnp.asarray(frames), jnp.asarray(src_hw, jnp.int32), 48,
        compute_dtype=jnp.float32, exact=exact))
    got = transforms.device_preprocess(frames, src_hw, 48,
                                       compute_dtype=torch.float32,
                                       exact=exact, device="cpu")
    tol = dict(rtol=0, atol=1e-4) if exact else dict(rtol=0, atol=1.0)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    again = transforms.device_preprocess(frames, src_hw, 48,
                                         compute_dtype=torch.float32,
                                         exact=exact, device="cpu")
    assert torch.equal(got, again)
    consts = transforms._norm_constants(
        tuple(transforms.IMAGENET_MEAN_255), tuple(transforms.IMAGENET_STD_1),
        torch.device("cpu"))
    assert all(a is b for a, b in zip(consts, transforms._norm_constants(
        tuple(transforms.IMAGENET_MEAN_255), tuple(transforms.IMAGENET_STD_1),
        torch.device("cpu"))))
    px = rng_np.integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    for mean, std in ((transforms.IMAGENET_MEAN_255,
                       transforms.IMAGENET_STD_1),
                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))):
        np.testing.assert_allclose(
            transforms.normalize_pixels(torch.from_numpy(px), mean, std,
                                        torch.float32).numpy(),
            np.asarray(j_transforms.normalize_pixels(
                jnp.asarray(px), mean, std, jnp.float32)),
            rtol=1e-6, atol=1e-5)


def _keys(scorer, call):
    """The graph keys ``call()`` runs on the scorer."""
    keys = []
    real = scorer._graphs.run

    def run(key, fn, *args):
        keys.append(key)
        return real(key, fn, *args)

    scorer._graphs.run = run
    try:
        call()
    finally:
        del scorer._graphs.run
    return keys


@pytest.mark.parametrize("hw, want", [((64, 64), (64, 64)),
                                      ((65, 64), (128, 64)),
                                      ((48, 127), (64, 128)),
                                      ((128, 129), (128, 192))])
def test_encode_bucket_key(scorer, hw, want):
    """A frame size lands on its 64 px collate bucket: one encode graph
    for every size up to the edge, the next one past it."""
    frames = np.zeros((N_CLIPS * NUM_FRM,) + hw + (3,), np.uint8)
    assert _keys(scorer, lambda: scorer.encode_frames(frames)) == [
        ("encode",) + want]


@pytest.mark.parametrize("n, want", [(1, 4), (4, 4), (5, 8), (8, 8)])
def test_text_bucket_key(scorer, n, want):
    """A caption count lands on its power-of-two bucket (floor 4, capped
    at max_captions): a request with frames runs the encode graph, then
    the bucket's scoring graph."""
    frames = np.zeros((N_CLIPS * NUM_FRM, 48, IMG, 3), np.uint8)
    feats = scorer.encode_frames(frames)
    assert _pow2_bucket(n, scorer.max_captions) == want
    assert _keys(scorer, lambda: scorer.score(None, CAPS[:n],
                                              features=feats)) == [
        ("text", want)]
    blob = video.encode_jseq_from_array(
        np.zeros((8, 48, IMG, 3), np.uint8), fps=8)
    assert _keys(scorer, lambda: scorer.score(blob, CAPS[:n])) == [
        ("encode", 64, IMG), ("text", want)]


def test_cuda_graphs_switch(tok):
    """cuda_graphs=True needs a CUDA device; None and False run eagerly on
    the CPU."""
    with pytest.raises(ValueError, match="CUDA device"):
        _scorer(tok, cuda_graphs=True)
    for flag in (None, False):
        sc = _scorer(tok, cuda_graphs=flag)
        assert not sc._graphs.enabled and sc._graphs.pool is None


def test_encode_frames_returns_the_callers_tensor(scorer, rng_np):
    """Features handed out are the caller's: a later encode of other
    frames leaves them as they were, and scoring on them later gives the
    same probabilities."""
    a = rng_np.integers(0, 256, (N_CLIPS * NUM_FRM, 48, IMG, 3), np.uint8)
    b = rng_np.integers(0, 256, (N_CLIPS * NUM_FRM, 48, IMG, 3), np.uint8)
    fa = scorer.encode_frames(a)
    kept = fa.clone()
    probs = scorer.score(None, CAPS[:3], features=fa)
    fb = scorer.encode_frames(b)
    assert torch.equal(fa, kept) and not torch.equal(fa, fb)
    scorer.score(None, CAPS[:3], features=fb)
    np.testing.assert_array_equal(scorer.score(None, CAPS[:3], features=fa),
                                  probs)


def test_model_guard():
    """A graph reads parameters where it recorded them: the guard passes
    in-place updates and raises on a replaced module, parameter storage
    or parameter."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    guard = cuda_graphs._ModelGuard(model)
    with torch.no_grad():
        model[0].weight.mul_(2.0)
    guard.check()
    for replace in (
            lambda: setattr(model, "1", linear.quantize_dense(model[1])),
            lambda: setattr(model[0].weight, "data",
                            model[0].weight.detach().clone()),
            lambda: setattr(model[0], "bias",
                            torch.nn.Parameter(torch.zeros(8)))):
        model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                    torch.nn.Linear(8, 2))
        guard = cuda_graphs._ModelGuard(model)
        replace()
        with pytest.raises(RuntimeError, match="replaced"):
            guard.check()


def test_concurrent_callers_get_their_serial_results(scorer, blob):
    """8 threads on one scorer, each with its own caption count (three
    buckets) and texts, some passing cached features: every result equals
    the thread's serial result. The switch interval is shortened so the
    threads interleave inside the calls."""
    feats = scorer.encode_video(blob)
    sets = [CAPS[i:i + 1 + i % 8] for i in range(8)]
    serial = [scorer.score(blob if i % 2 else None, s,
                           features=None if i % 2 else feats)
              for i, s in enumerate(sets)]
    got = [[] for _ in sets]
    barrier = threading.Barrier(len(sets))

    def work(i):
        barrier.wait(timeout=60)
        for _ in range(3):
            got[i].append(scorer.score(blob if i % 2 else None, sets[i],
                                       features=None if i % 2 else feats))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(sets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for want, results in zip(serial, got):
        assert len(results) == 3
        for r in results:
            np.testing.assert_array_equal(r, want)


def test_sustained_load(scorer, blob):
    """bench_serving.sustained_load on the CPU scorer: 2 HTTP clients for
    about a second, each with its own captions; no errors, every response
    its client's serial result, no graph captured (the CPU runs
    eagerly)."""
    sets = bench_serving.caption_sets(2, scorer.max_captions)
    assert [len(s) for s in sets] == [1, 4]
    stats = bench_serving.sustained_load(scorer, blob, sets, seconds=1.0)
    assert stats["n_ok"] > 0, stats
    assert stats["n_err"] == 0 and stats["n_mismatch"] == 0, stats
    assert stats["captures_after_warmup"] == 0 and stats["clients"] == 2
    assert set(stats) >= {"qps", "p50_ms", "p99_ms", "seconds"}
