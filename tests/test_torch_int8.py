"""The port's int8 scoring path against the JAX package's on the CPU,
mirroring tests/test_int8.py: ops/linear.py's quantize_dense (bit for bit,
after the transpose of nn.Linear's (out, in) layout) and _qlinear (equal:
the integer product is exact and the dequantization runs in the JAX
order), the merged int8 QKV against three separate products and against
the JAX attention's int8 branch, models/clipbert.py::
quantize_scoring_params (the same leaves as the JAX function, each equal
to its JAX quantization), the quantized scoring probabilities against the
JAX quantized ones and within test_int8.py's 0.08 of the floating ones,
int_mm's zero padding to torch._int_mm's CUDA shape rules, and
``serve.main --quantize 1`` answering /score, /vqa and /videoqa."""

import importlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.ops.attention import multi_head_attention as j_mha
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch import serve
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import tokenization, video
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import linear as lin
from clipbert_tpu_torch.ops.attention import (SelfAttention,
                                             multi_head_attention)
from clipbert_tpu_torch.train import steps
from test_torch_heads import random_params

# the ops package re-exports the `linear` function under the module's name
j_lin = importlib.import_module("clipbert_tpu.ops.linear")

TINY = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, backbone_channel_in_size=2048,
            num_labels=2, loss_type="ce", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# the e2e probabilities: the same int8 products and fp32 arithmetic in
# another order (BERT's LayerNorms, softmax) as the fp32 parity bound of
# tests/test_torch_eval.py
PROB_TOL = dict(rtol=2e-4, atol=2e-5)
QUANT_ATOL = 0.08          # tests/test_int8.py, quantized against fp


def _dense(rng, d_in, d_out):
    return {"kernel": rng.normal(0, 0.05, (d_in, d_out)).astype(np.float32),
            "bias": rng.normal(0, 0.01, (d_out,)).astype(np.float32)}


def _linear(p):
    """An nn.Linear holding the JAX dense ``p`` ((in, out) kernel)."""
    layer = torch.nn.Linear(*p["kernel"].shape)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(p["kernel"].T))
        layer.bias.copy_(torch.from_numpy(p["bias"]))
    return layer


def test_quantize_dense_equals_jax_bit_for_bit(rng_np):
    p = _dense(rng_np, 64, 48)
    p["kernel"][:, 5] = 0.0                     # an all-zero channel: 1e-12
    want = j_lin.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    got = lin.quantize_dense(_linear(p))
    assert isinstance(got, lin.QuantLinear)
    assert got.weight_i8.dtype == torch.int8
    np.testing.assert_array_equal(got.weight_i8.numpy(),
                                  np.asarray(want["kernel_i8"]).T)
    np.testing.assert_array_equal(got.kscale.numpy(),
                                  np.asarray(want["kscale"]))
    np.testing.assert_array_equal(got.bias.numpy(), p["bias"])
    assert lin.quantize_dense(got) is got                  # idempotent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_equals_jax(rng_np, dtype):
    """_qlinear on (3, 7, 64) activations equals the JAX linear on the
    quantized params, and stays within test_int8.py's quantization error
    of the floating product."""
    p = _dense(rng_np, 64, 48)
    x = rng_np.normal(0, 1.0, (3, 7, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = j_lin.linear(jx, j_lin.quantize_dense(
        {k: jnp.asarray(v) for k, v in p.items()}))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = lin.linear(tx, lin.quantize_dense(_linear(p)))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    fp = lin.linear(tx, _linear(p)).detach().float().numpy()
    err = np.abs(got.float().numpy() - fp).max() / np.abs(fp).max()
    assert err < 0.05


def test_merged_qkv_equals_three_products_and_jax(rng_np):
    """The merged int8 QKV (ops/attention.py) equals the three separate
    quantized products, and the attention built on it equals the JAX
    attention's int8 branch."""
    B, L, D, H = 2, 9, 32, 4
    params = {n: _dense(rng_np, D, D) for n in ("query", "key", "value")}
    sa = SelfAttention(D)
    for n in params:
        setattr(sa, n, lin.quantize_dense(_linear(params[n])))
    x = rng_np.normal(0, 1.0, (B, L, D)).astype(np.float32)
    tx = torch.from_numpy(x)
    merged = lin._qlinear(
        tx, torch.cat([getattr(sa, n).weight_i8 for n in params]),
        torch.cat([getattr(sa, n).kscale for n in params]),
        torch.cat([getattr(sa, n).bias for n in params]))
    for part, n in zip(merged.split(D, dim=-1), params):
        assert torch.equal(part, lin.linear(tx, getattr(sa, n)))
    mask = torch.zeros(B, 1, 1, L)
    got = multi_head_attention(tx, sa, H, mask)
    jq = {n: j_lin.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
          for n, p in params.items()}
    want = j_mha(jnp.asarray(x), jq, H, mask_bias=jnp.zeros((B, 1, 1, L)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_int_mm_pads_to_the_cuda_rules(rng_np, monkeypatch):
    """One row, K = 20, N = 2 (the retrieval head's product for a single
    caption): zero-padded to 17 x 24 @ 24 x 8, sliced back, exact; a shape
    inside the rules does not pad (the shapes torch._int_mm is given)."""
    shapes = []
    real = torch._int_mm

    def recording(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", recording)
    for (M, K, N), want in (((1, 20, 2), ((17, 24), (24, 8))),
                            ((24, 32, 16), ((24, 32), (32, 16)))):
        a = torch.from_numpy(rng_np.integers(-127, 128, (M, K))
                             .astype(np.int8))
        w = torch.from_numpy(rng_np.integers(-127, 128, (N, K))
                             .astype(np.int8))
        got = lin.int_mm(a, w)
        assert shapes.pop() == want
        assert got.dtype == torch.int32 and got.shape == (M, N)
        assert torch.equal(got.long(), a.long() @ w.long().t())


@pytest.fixture(scope="module")
def e2e():
    """A retrieval tree of the JAX structure filled from numpy
    (tests/test_torch_heads.py::random_params) and the port model on it."""
    params = jax.tree.map(np.asarray, random_params(
        JModelConfig(**TINY), "retrieval", 0))
    cfg = ModelConfig(**TINY)
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"),
                            params)
    return params, cfg, model.eval().requires_grad_(False)


def test_quantize_scoring_params_structure(e2e):
    """The leaves of the JAX function become QuantLinear, each equal to its
    JAX quantization; embeddings, LayerNorms and the CNN stay floating."""
    params, cfg, model = e2e
    cnn = {n: t.clone() for n, t in model.cnn.state_dict().items()}
    q = clipbert.quantize_scoring_params(
        load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"), params))
    jq = j_clipbert.quantize_scoring_params(params)
    jenc = jq["transformer"]["bert"]["encoder"]
    for i, lp in enumerate(q.transformer.bert.encoder.layers):
        pairs = [(getattr(lp.attention.self, n), jenc["attention"]["self"][n])
                 for n in ("query", "key", "value")]
        pairs += [(lp.attention.output.dense,
                   jenc["attention"]["output"]["dense"]),
                  (lp.intermediate.dense, jenc["intermediate"]["dense"]),
                  (lp.output.dense, jenc["output"]["dense"])]
        for layer, jp in pairs:
            assert isinstance(layer, lin.QuantLinear)
            np.testing.assert_array_equal(layer.weight_i8.numpy(),
                                          np.asarray(jp["kernel_i8"][i]).T)
            np.testing.assert_array_equal(layer.kscale.numpy(),
                                          np.asarray(jp["kscale"][i]))
        assert isinstance(lp.attention.output.ln, torch.nn.LayerNorm)
    assert isinstance(q.transformer.bert.pooler.dense, lin.QuantLinear)
    for n in ("fc1", "fc2"):
        layer = getattr(q.transformer.classifier, n)
        assert isinstance(layer, lin.QuantLinear)
        np.testing.assert_array_equal(
            layer.weight_i8.numpy(),
            np.asarray(jq["transformer"]["classifier"][n]["kernel_i8"]).T)
    assert not any(isinstance(m, lin.QuantLinear)
                   for m in q.transformer.bert.embeddings.modules())
    assert all(torch.equal(t, cnn[n])
               for n, t in q.cnn.state_dict().items())
    assert not any(isinstance(m, lin.QuantLinear) for m in q.cnn.modules())


def test_quantized_scoring_matches_jax(e2e, rng_np):
    """test_int8.py's e2e case: the quantized prob step equals the JAX
    quantized one, and stays within 0.08 of the floating probabilities."""
    params, cfg, model = e2e
    kw = dict(head_type="retrieval", num_labels=2, loss_type="ce",
              score_agg_func="lse", train_n_clips=1, group_size=1)
    B_t, Lt = 6, 8
    feats = rng_np.normal(0, 1.0, (1, 1, 2, 2, 2, 32)).astype(np.float32)
    ids = rng_np.integers(4, 99, (B_t, Lt)).astype(np.int32)
    mask = np.ones((B_t, Lt), np.int32)
    jprob = j_steps.make_text_prob_step(
        JModelConfig(**TINY), j_steps.TaskSettings(**kw),
        compute_dtype=jnp.float32, fused_attn=False)
    jq = np.asarray(jprob(j_clipbert.quantize_scoring_params(params),
                          jnp.asarray(feats), jnp.asarray(ids),
                          jnp.asarray(mask)))[0]
    prob = steps.make_text_prob_step(cfg, steps.TaskSettings(**kw),
                                     torch.float32, fused_attn=False)
    args = (torch.from_numpy(feats), torch.from_numpy(ids).long(),
            torch.from_numpy(mask).long())
    fp = prob(model, *args)[0].numpy()
    qmodel = clipbert.quantize_scoring_params(
        load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"), params))
    got = prob(qmodel, *args)[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jq, **PROB_TOL)
    np.testing.assert_allclose(got, fp, rtol=0, atol=QUANT_ATOL)
    assert not np.array_equal(got, fp)


# ---------------------------------------------------------------------------
# serve.main --quantize 1
# ---------------------------------------------------------------------------

def _serve_once(monkeypatch, argv, path, payload):
    """serve.main(argv) with its server answering one POST to ``path``
    (on an ephemeral port) before serve_forever returns; returns (status,
    body, the scorer the server was built on)."""
    seen = {}
    real = serve.make_http_server

    class Probe:
        def __init__(self, scorer, host, port, **kw):
            self.server = real(scorer, host, 0, **kw)
            seen["scorer"] = scorer or next(v for v in kw.values() if v)

        def serve_forever(self):
            t = threading.Thread(target=self.server.serve_forever,
                                 daemon=True)
            t.start()
            req = urllib.request.Request(
                f"http://127.0.0.1:{self.server.server_address[1]}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                seen["status"], seen["body"] = r.status, json.loads(r.read())
            self.server.shutdown()
            self.server.server_close()
            t.join(timeout=10)

    monkeypatch.setattr(serve, "make_http_server", Probe)
    serve.main(argv)
    return seen["status"], seen["body"], seen["scorer"]


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    """Deploy .npz files (written by the JAX package) for a retrieval, a
    VQA and a frameqa model, their config, a vocab and an ans2label."""
    from clipbert_tpu.ckpt.checkpoint import save_tree
    from PIL import Image
    import base64
    import io
    root = tmp_path_factory.mktemp("int8_serve")
    tokenization.write_tiny_vocab(str(root / "vocab.txt"),
                                  extra_tokens=["cat", "dog", "runs"])
    tok = tokenization.BertTokenizer.from_dir(str(root))
    base = dict(vocab_size=len(tok), hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64,
                max_grid_row_position_embeddings=4,
                max_grid_col_position_embeddings=4)
    (root / "model.json").write_text(json.dumps(base))
    (root / "a2l.json").write_text(json.dumps({f"ans{i}": i
                                               for i in range(6)}))
    for name, head, n, loss in (("ret", "retrieval", 2, "ce"),
                                ("vqa", "seq_cls", 6, "bce"),
                                ("oe", "seq_cls", 6, "ce")):
        params = random_params(JModelConfig(**dict(base, num_labels=n,
                                                   loss_type=loss)), head, 3)
        save_tree(str(root / f"{name}.npz"), params)
    rng = np.random.default_rng(2)
    blob = video.encode_jseq_from_array(
        rng.integers(0, 255, (8, 48, 64, 3)).astype(np.uint8), fps=4)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)).save(
        buf, format="PNG")
    return {"root": root,
            "video": base64.b64encode(blob).decode(),
            "image": base64.b64encode(buf.getvalue()).decode()}


@pytest.mark.parametrize("task,path", [("retrieval", "/score"),
                                       ("vqa", "/vqa"),
                                       ("frameqa", "/videoqa")])
def test_serve_main_quantize_answers(serve_world, monkeypatch, task, path):
    root = serve_world["root"]
    ckpt = {"retrieval": "ret", "vqa": "vqa", "frameqa": "oe"}[task]
    argv = ["--task", task, "--model_config", str(root / "model.json"),
            "--tokenizer_dir", str(root),
            "--e2e_weights_path", str(root / f"{ckpt}.npz"),
            "--ans2label_path", str(root / "a2l.json"), "--device", "cpu",
            "--max_img_size", "64", "--max_captions", "4", "--num_frm", "1",
            "--fps", "2", "--warmup_resolutions", "48x64",
            "--quantize", "1"]
    payload = ({"image_b64": serve_world["image"], "questions": ["a cat"]}
               if task == "vqa" else
               {"video_b64": serve_world["video"],
                "captions" if task == "retrieval" else "questions":
                    ["a cat runs", "dog"]})
    status, body, scorer = _serve_once(monkeypatch, argv, path, payload)
    assert status == 200
    layers = scorer.model.transformer.bert.encoder.layers
    assert all(isinstance(lp.intermediate.dense, lin.QuantLinear)
               for lp in layers)
    if task == "retrieval":
        assert len(body["probs"]) == 2
        assert all(0.0 <= s <= 1.0 for s in body["probs"])
    else:
        assert len(body["answers"]) == (1 if task == "vqa" else 2)
