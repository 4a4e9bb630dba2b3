"""The port's VQA and video-QA scorers against the JAX package's, on the
CPU, and their HTTP routes (/vqa, /videoqa, /videoqa_mc) with the JAX
server's 400 / 404 / 500 split, mirroring tests/test_serve.py. Weights
cross with ckpt/from_jax.py; inputs come from numpy.

Tolerance: rtol 2e-4, atol 2e-5 on fp32 probabilities, the bound of
tests/test_torch_eval.py; the top-k answers must be equal."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import save_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.serve import VideoQAScorer as JVideoQAScorer
from clipbert_tpu.serve import VQAScorer as JVQAScorer
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import tokenization, video
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.serve import (RetrievalScorer, VideoQAScorer,
                                      VQAScorer, make_http_server)

TOL = dict(rtol=2e-4, atol=2e-5)
N_CLIPS, NUM_FRM, IMG = 2, 2, 64
LABEL2ANS = {i: f"ans{i}" for i in range(6)}
QS = ["a cat runs", "the dog"]
OPTS = ["runs", "dog", "a", "cat", "the"]


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
    and non-trivial LayerNorm and frozen BN."""
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
            a = (0.2 if "classifier" not in keys else 1.0) * \
                rng.standard_normal(s.shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: j_clipbert.init_clipbert(
        jax.random.key(0), jcfg, head))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(tree, cfg, head):
    return load_jax_params(clipbert.empty_clipbert(cfg, head, device="cpu"),
                           tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX and port scorers on the same weights: VQA (bce over 6 answers),
    open-ended frameqa (ce over 6) and multiple-choice transition, at the
    sizes of tests/test_serve.py; a JSEQ video blob and an odd-size PNG."""
    from PIL import Image
    root = tmp_path_factory.mktemp("serve_qa")
    vocab = root / "vocab.txt"
    tokenization.write_tiny_vocab(
        str(vocab), extra_tokens=["cat", "dog", "runs", "a", "the"])
    tok = tokenization.BertTokenizer(str(vocab))
    base = dict(vocab_size=len(tok), hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64,
                max_grid_row_position_embeddings=4,
                max_grid_col_position_embeddings=4)
    rng = np.random.default_rng(9)
    blob = video.encode_jseq_from_array(
        rng.integers(0, 255, (12, 48, IMG, 3)).astype(np.uint8), fps=8)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (40, 52, 3)).astype(np.uint8)).save(
        buf, format="PNG")          # odd size: exercises the 64 px bucket
    out = {"root": root, "tok": tok, "blob": blob, "img": buf.getvalue(),
           "base": base}
    vid = dict(num_frm=NUM_FRM, n_clips=N_CLIPS, fps=4, max_img_size=IMG,
               max_txt_len=8, score_agg_func="mean")
    for name, head, n, loss, seed in (("vqa", "seq_cls", 6, "bce", 7),
                                      ("oe", "seq_cls", 6, "ce", 13),
                                      ("mc", "multi_choice", 5, "ce", 17)):
        kw = dict(base, num_labels=n, loss_type=loss)
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        params = random_params(jcfg, head, seed)
        if name == "vqa":
            common = dict(max_img_size=IMG, max_txt_len=8, max_questions=8)
            jsc = JVQAScorer(params, jcfg, tok, LABEL2ANS,
                             compute_dtype=jnp.float32, **common)
            sc = VQAScorer(_port(params, cfg, head), cfg, tok, LABEL2ANS,
                           device="cpu", compute_dtype=torch.float32,
                           **common)
        else:
            task = "frameqa" if name == "oe" else "transition"
            extra = ({"label2ans": LABEL2ANS, "max_questions": 8}
                     if name == "oe" else {})
            jsc = JVideoQAScorer(params, jcfg, tok, task,
                                 compute_dtype=jnp.float32, **vid, **extra)
            sc = VideoQAScorer(_port(params, cfg, head), cfg, tok, task,
                               device="cpu", compute_dtype=torch.float32,
                               **vid, **extra)
        out[name] = {"jax": jsc, "port": sc, "params": params, "cfg": cfg,
                     "common": common if name == "vqa" else dict(vid, **extra)}
    return out


def _assert_same_topk(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [e["answer"] for e in g] == [e["answer"] for e in w]
        np.testing.assert_allclose([e["score"] for e in g],
                                   [e["score"] for e in w], **TOL)


def test_vqa_scorer_matches_jax(world):
    """Top-k answers and scores against the JAX scorer; question-bucket
    padding does not leak; bad requests raise ValueError."""
    sc, img = world["vqa"]["port"], world["img"]
    got = sc.answer(img, QS, top_k=3)
    _assert_same_topk(got, world["vqa"]["jax"].answer(img, QS, top_k=3))
    assert all(0 <= e["score"] <= 1 for r in got for e in r)
    probs = sc.probs(img, QS)
    assert probs.shape == (2, 6) and not np.allclose(probs.sum(-1), 1.0)
    more = sc.probs(img, QS + ["cat"] * 3)                 # bucket 8
    np.testing.assert_allclose(more[:2], probs, rtol=1e-5, atol=1e-6)
    feats = sc.encode_image(img)
    assert tuple(feats.shape) == (1, 1, 1, 1, 32)
    np.testing.assert_allclose(sc.probs(None, QS, features=feats), probs,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        sc.encode_image(b"not an image")
    with pytest.raises(ValueError):
        sc.answer(img, ["q"] * 9)                          # > max_questions
    with pytest.raises(ValueError):
        sc.answer(img, [])
    assert fa.LAUNCHES == 0                                # CPU: plain


def test_videoqa_open_ended_matches_jax(world):
    sc, blob = world["oe"]["port"], world["blob"]
    got = sc.answer(blob, QS, top_k=3)
    _assert_same_topk(got, world["oe"]["jax"].answer(blob, QS, top_k=3))
    probs = sc.probs(blob, QS)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    more = sc.probs(blob, QS + ["cat"] * 3)
    np.testing.assert_allclose(more[:2], probs, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        sc.answer_mc(blob, "q", ["a"] * 5)     # MC entry on an open task
    with pytest.raises(ValueError):
        sc.encode_video(b"not a video")


def test_videoqa_mc_matches_jax(world):
    """Option probabilities of the multi-choice head on the question +
    option texts against the JAX scorer; cached features reproduce the
    bytes path."""
    sc, blob = world["mc"]["port"], world["blob"]
    probs = sc.answer_mc(blob, "the cat", OPTS)
    want = world["mc"]["jax"].answer_mc(blob, "the cat", OPTS)
    assert probs.shape == (5,)
    np.testing.assert_allclose(probs, want, **TOL)
    assert int(np.argmax(probs)) == int(np.argmax(want))
    np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-5)
    feats = sc.encode_video(blob)
    assert tuple(feats.shape) == (1, N_CLIPS, NUM_FRM, 1, 1, 32)
    np.testing.assert_allclose(sc.answer_mc(None, "the cat", OPTS,
                                            features=feats), probs,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        sc.answer_mc(blob, "the cat", OPTS[:3])            # option count
    with pytest.raises(ValueError):
        sc.answer(blob, ["q"])                 # open entry on an MC task


@pytest.mark.parametrize("name", ["vqa", "oe", "mc"])
def test_from_checkpoint_loads_a_jax_deploy_npz(world, name, tmp_path):
    """The serve CLI's load path: a deploy .npz written by the JAX
    package's own checkpoint writer, through the weight bridge."""
    w = world[name]
    ckpt = tmp_path / "model_step_1.npz"
    save_tree(str(ckpt), w["params"])
    cfg_json = tmp_path / "model_config.json"
    cfg_json.write_text(json.dumps(world["base"]))
    vocab_dir = world["root"]
    a2l = tmp_path / "ans2label.json"
    a2l.write_text(json.dumps({v: k for k, v in LABEL2ANS.items()}))
    common = {k: v for k, v in w["common"].items() if k != "label2ans"}
    if name == "vqa":
        loaded = VQAScorer.from_checkpoint(
            str(cfg_json), str(vocab_dir), str(ckpt), str(a2l),
            device="cpu", compute_dtype=torch.float32, **common)
        np.testing.assert_array_equal(loaded.probs(world["img"], QS),
                                      w["port"].probs(world["img"], QS))
    elif name == "oe":
        loaded = VideoQAScorer.from_checkpoint(
            str(cfg_json), str(vocab_dir), str(ckpt), "frameqa",
            device="cpu", ans2label_path=str(a2l),
            compute_dtype=torch.float32, **common)
        np.testing.assert_array_equal(loaded.probs(world["blob"], QS),
                                      w["port"].probs(world["blob"], QS))
    else:
        loaded = VideoQAScorer.from_checkpoint(
            str(cfg_json), str(vocab_dir), str(ckpt), "transition",
            device="cpu", compute_dtype=torch.float32, **common)
        np.testing.assert_array_equal(
            loaded.answer_mc(world["blob"], "the cat", OPTS),
            w["port"].answer_mc(world["blob"], "the cat", OPTS))
        with pytest.raises(ValueError):
            VideoQAScorer.from_checkpoint(str(cfg_json), str(vocab_dir),
                                          str(tmp_path / "x.pt"),
                                          "transition", device="cpu")


class _Server:
    def __init__(self, *args, **kw):
        self.server = make_http_server(*args, port=0, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.port = self.server.server_address[1]

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def post(self, path, payload):
        """(status, body); an HTTP error's status and body too."""
        data = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def _b64(b):
    return base64.b64encode(b).decode()


def test_vqa_http_route(world):
    sc, img = world["vqa"]["port"], world["img"]
    with _Server(None, vqa=sc) as s:
        code, body = s.post("/vqa", {"image_b64": _b64(img),
                                     "questions": ["a cat"], "top_k": 2})
        assert code == 200
        direct = sc.answer(img, ["a cat"], top_k=2)
        assert [e["answer"] for e in body["answers"][0]] == \
            [e["answer"] for e in direct[0]]
        np.testing.assert_allclose([e["score"] for e in body["answers"][0]],
                                   [e["score"] for e in direct[0]],
                                   rtol=1e-6)
        # the other families' routes are 404 on a vqa-only server
        for path in ("/score", "/videoqa", "/videoqa_mc", "/nope"):
            assert s.post(path, {"video_b64": "", "captions": ["x"]})[0] \
                == 404, path
        assert s.post("/vqa", {"image_b64": "!!", "questions": ["q"]})[0] \
            == 400                                       # bad base64
        assert s.post("/vqa", {"questions": ["q"]})[0] == 400   # no image
        assert s.post("/vqa", {"image_b64": _b64(b"x"),
                               "questions": ["q"]})[0] == 400  # not an image
        assert s.post("/vqa", {"image_b64": _b64(img),
                               "questions": ["q"] * 9})[0] == 400


def test_videoqa_http_routes(world):
    oe, mc, blob = world["oe"]["port"], world["mc"]["port"], world["blob"]
    with _Server(None, videoqa=oe) as s:
        code, body = s.post("/videoqa", {"video_b64": _b64(blob),
                                         "questions": ["a cat"],
                                         "top_k": 2})
        assert code == 200
        assert body["answers"][0][0]["answer"] == \
            oe.answer(blob, ["a cat"], top_k=2)[0][0]["answer"]
        assert s.post("/videoqa_mc", {"video_b64": _b64(blob),
                                      "question": "q",
                                      "options": OPTS})[0] == 404
        assert s.post("/vqa", {"image_b64": "", "questions": []})[0] == 404
    with _Server(None, videoqa=mc) as s:
        code, body = s.post("/videoqa_mc", {"video_b64": _b64(blob),
                                            "question": "the cat",
                                            "options": OPTS})
        assert code == 200
        direct = mc.answer_mc(blob, "the cat", OPTS)
        assert body["answer_index"] == int(np.argmax(direct))
        np.testing.assert_allclose(body["probs"], direct, rtol=1e-5)
        assert s.post("/videoqa", {"video_b64": _b64(blob),
                                   "questions": ["q"]})[0] == 404
        assert s.post("/videoqa_mc", {"video_b64": _b64(blob),
                                      "question": "q",
                                      "options": OPTS[:2]})[0] == 400
        assert s.post("/videoqa_mc", b"{not json")[0] == 400


def test_concurrent_requests_across_endpoints(world, tmp_path):
    """Twelve parallel POSTs across /score, /vqa and /videoqa on one
    threaded server, a malformed one mixed in: every answer equals the
    sequential one (tests/test_serve.py:422-490)."""
    kw = dict(world["base"], num_labels=2, loss_type="ce",
              score_agg_func="lse")
    cfg = ModelConfig(**kw)
    ret = RetrievalScorer(
        _port(random_params(JModelConfig(**kw), "retrieval", 5), cfg,
              "retrieval"), cfg, world["tok"], device="cpu",
        compute_dtype=torch.float32, num_frm=NUM_FRM, n_clips=N_CLIPS, fps=4,
        max_img_size=IMG, max_txt_len=8, max_captions=8)
    vqa, oe = world["vqa"]["port"], world["oe"]["port"]
    blob, img = world["blob"], world["img"]
    want = {"/score": ret.score(blob, QS).tolist(),
            "/vqa": vqa.answer(img, ["a cat"], top_k=2),
            "/videoqa": oe.answer(blob, ["a cat"], top_k=2)}
    reqs = [("/score", {"video_b64": _b64(blob), "captions": QS}),
            ("/vqa", {"image_b64": _b64(img), "questions": ["a cat"],
                      "top_k": 2}),
            ("/videoqa", {"video_b64": _b64(blob), "questions": ["a cat"],
                          "top_k": 2}),
            ("/score", {"video_b64": "!!", "captions": QS})] * 3
    with _Server(ret, vqa=vqa, videoqa=oe) as s:
        with ThreadPoolExecutor(12) as pool:
            results = list(pool.map(lambda r: (r[0], r[1], *s.post(*r)),
                                    reqs))
    assert len(results) == 12
    for path, payload, code, body in results:
        if payload.get("video_b64") == "!!":
            assert code == 400, body
        elif path == "/score":
            assert code == 200, body
            np.testing.assert_allclose(body["probs"], want[path], rtol=1e-5,
                                       atol=1e-6)
        else:
            assert code == 200, body
            assert [e["answer"] for e in body["answers"][0]] == \
                [e["answer"] for e in want[path][0]]


class _Boom:
    """A scorer whose every call fails inside: the server's 500 path."""
    is_mc = False

    def answer(self, *a, **kw):
        raise RuntimeError("secret internal state: /some/path")

    answer_mc = score = answer


@pytest.mark.parametrize("route", ["/vqa", "/videoqa", "/videoqa_mc"])
def test_http_error_codes_split_client_vs_server(route):
    """A missing field is a 400; a scorer failing inside is a 500 whose
    body does not echo the exception (tests/test_serve.py:493-531)."""
    boom = _Boom()
    boom.is_mc = route == "/videoqa_mc"
    kw = {"vqa": boom} if route == "/vqa" else {"videoqa": boom}
    full = {"/vqa": {"image_b64": _b64(b"x"), "questions": ["q"]},
            "/videoqa": {"video_b64": _b64(b"x"), "questions": ["q"]},
            "/videoqa_mc": {"video_b64": _b64(b"x"), "question": "q",
                            "options": OPTS}}[route]
    with _Server(None, **kw) as s:
        missing = dict(full)
        missing.pop(next(iter(full)))
        assert s.post(route, missing)[0] == 400
        code, body = s.post(route, full)
        assert code == 500
        assert "secret internal state" not in json.dumps(body)
        assert s.post("/score", full)[0] == 404
