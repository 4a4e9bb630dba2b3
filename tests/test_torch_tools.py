"""The port's released-checkpoint harness (clipbert_tpu_torch/verify_ckpt.py)
and media ingest (clipbert_tpu_torch/data/ingest.py) against the JAX
package's on the CPU.

verify_ckpt: run_verification on a synthetic deploy .npz (written by the
JAX package's checkpoint writer) and video store, at
tests/test_tasks_e2e.py::test_verify_ckpt_harness_smoke's tiny config:
the R@K, the protocol and the report equal the JAX harness's, and the
score matrix within tests/test_torch_eval.py's fp32 bound; the 1-clip and
data-ratio overrides reach the protocol; ``main`` prints the report.

ingest: seeded JPEGs and a PNG, and JSEQ videos (stored raw, and
transcoded), through both packages' ingest: the CBPK files are equal byte
for byte, and read back through the port's store."""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from clipbert_tpu import verify_ckpt as j_verify_ckpt
from clipbert_tpu.ckpt.checkpoint import save_tree
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.data import ingest as j_ingest
from clipbert_tpu_torch import verify_ckpt
from clipbert_tpu_torch.data import ingest, store, tokenization, video
from test_torch_heads import random_params

EVAL_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_torch_eval.py
# tests/test_tasks_e2e.py::TINY_MODEL_CFG
TINY_MODEL_CFG = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=64,
    max_grid_row_position_embeddings=4, max_grid_col_position_embeddings=4,
    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """test_tasks_e2e.py's workspace, cut to what the harness reads: a
    vocab, the model config, 4 JSEQ videos, 4 captions, a JAX-written
    deploy checkpoint and the run config."""
    root = tmp_path_factory.mktemp("verify")
    tok_dir = root / "tokenizer"
    tok_dir.mkdir()
    tokenization.write_tiny_vocab(
        str(tok_dir / "vocab.txt"),
        extra_tokens=["cat", "dog", "bird", "runs", "jumps", "a", "the"])
    tok = tokenization.BertTokenizer.from_dir(str(tok_dir))
    (root / "model_config.json").write_text(
        json.dumps(dict(TINY_MODEL_CFG, vocab_size=len(tok))))
    with store.PackWriter(str(root / "vids.cbpk")) as w:
        for i in range(4):
            frames = np.zeros((16, 32, 32, 3), np.uint8)
            frames[:, :, :, 0] = (i * 19) % 255
            for t in range(16):
                frames[t, :, :, 1] = t * 15
            w.put(f"vid{i}", video.encode_jseq_from_array(frames, fps=8))
    (root / "ann.jsonl").write_text("".join(
        json.dumps({"vid_id": f"vid{i}", "txt": f"a dog jumps {i}",
                    "id": i}) + "\n" for i in range(4)))
    jcfg = JModelConfig.from_json(str(root / "model_config.json"),
                                  num_labels=2, loss_type="ce")
    save_tree(str(root / "model.npz"), random_params(jcfg, "retrieval", 3))
    (root / "cfg.json").write_text(json.dumps({
        "model_config": str(root / "model_config.json"), "fps": 4,
        "num_frm": 1, "inference_n_clips": 2, "score_agg_func": "lse",
        "max_img_size": 64, "max_txt_len": 10, "loss_type": "ce",
        "inference_batch_size": 4, "bf16": False}))
    return root


def _args(ws):
    return (str(ws / "model.npz"), str(ws / "ann.jsonl"),
            str(ws / "vids.cbpk"), str(ws / "tokenizer"))


@pytest.mark.parametrize("override", [{}, {"inference_n_clips": 1,
                                           "data_ratio": 0.5}])
def test_verify_ckpt_matches_jax(ws, override):
    want = j_verify_ckpt.run_verification(*_args(ws), config=str(
        ws / "cfg.json"), **override)
    got = verify_ckpt.run_verification(*_args(ws), config=str(
        ws / "cfg.json"), device="cpu", **override)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["score_matrix"], want["score_matrix"],
                               **EVAL_TOL)
    for k in want:
        if k != "score_matrix":
            assert got[k] == want[k], k
    assert verify_ckpt.format_report(got) == \
        j_verify_ckpt.format_report(want)
    n = 2 if override else 4
    assert got["protocol"]["n_examples"] == n
    assert got["protocol"]["inference_n_clips"] == (1 if override else 2)
    assert got["score_matrix"].shape == (n, n)


def test_verify_ckpt_main_prints_the_report(ws, capsys):
    path, txt, img, tok = _args(ws)
    m = verify_ckpt.main(["--e2e_weights_path", path, "--txt_db", txt,
                          "--img_db", img, "--tokenizer_dir", tok,
                          "--config", str(ws / "cfg.json"),
                          "--inference_n_clips", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip() == verify_ckpt.format_report(m)
    assert "t2v_r1" in out and "paper" in out


def _jpeg(rng, h, w):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_ingest_equals_jax_and_reads_back(tmp_path):
    rng = np.random.default_rng(11)
    src = tmp_path / "media"
    (src / "sub").mkdir(parents=True)
    jpegs = {f"img{i}": _jpeg(rng, 24 + 8 * i, 40) for i in range(3)}
    for k, b in jpegs.items():
        (src / ("sub" if k == "img2" else "") / f"{k}.jpg").write_bytes(b)
    png = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    Image.fromarray(png).save(src / "pic.png")
    (src / "notes.txt").write_text("not media")
    clips = {f"clip{i}": video.encode_jseq_from_array(
        rng.integers(0, 256, (6, 32, 48, 3)).astype(np.uint8), fps=6)
        for i in range(2)}
    for k, b in clips.items():
        (src / f"{k}.mp4").write_bytes(b)

    outs = {}
    for pkg, mod in (("port", ingest), ("jax", j_ingest)):
        img_out = tmp_path / f"{pkg}_img.cbpk"
        if pkg == "port":               # the CLI, as python -m runs it
            ingest.main(["--input_root", str(src), "--output", str(img_out),
                         "--type", "image", "--num_workers", "2"])
        else:
            mod.ingest(str(src), str(img_out), "image", num_workers=2)
        raw_out = tmp_path / f"{pkg}_raw.cbpk"
        jseq_out = tmp_path / f"{pkg}_jseq.cbpk"
        assert mod.ingest(str(src), str(raw_out), "video", num_workers=2) \
            == (2, [])
        assert mod.ingest(str(src), str(jseq_out), "video", to_jseq=True,
                          fps=6, num_workers=2) == (2, [])
        outs[pkg] = [p.read_bytes() for p in (img_out, raw_out, jseq_out)]
    assert outs["port"] == outs["jax"]

    imgs = store.open_store(str(tmp_path / "port_img.cbpk"))
    assert sorted(imgs.keys()) == ["img0", "img1", "img2", "pic"]
    for k, b in jpegs.items():
        assert imgs.get(k) == b                     # JPEGs pass through
    back = np.asarray(Image.open(io.BytesIO(imgs.get("pic"))))
    assert back.shape == png.shape                  # re-encoded to JPEG
    assert np.abs(back.astype(int) - png).mean() < 60
    raw = store.open_store(str(tmp_path / "port_raw.cbpk"))
    assert {k: raw.get(k) for k in clips} == clips
    jseq = store.open_store(str(tmp_path / "port_jseq.cbpk"))
    for k in clips:
        assert video.probe(jseq.get(k)) == video.probe(clips[k])
        frames = video.decode_indices(jseq.get(k), np.arange(6))
        assert frames.shape == (6, 32, 48, 3)
