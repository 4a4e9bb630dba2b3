"""The port's MSRVTT retrieval eval path against the JAX package's, on the
CPU: the bench unit ``steps.mil_forward``, ``inference_retrieval`` on one
synthetic JPEG-sequence store, and the ``run_video_retrieval`` CLI on a
``model_step_N.npz`` written by the JAX package's own ModelSaver. Weights
cross with ckpt/from_jax.py; inputs come from numpy.

Tolerance: rtol 2e-4, atol 2e-5 on probabilities and logits in fp32, the
bound tests/test_torch_slice.py holds the scorer to (fp32 sums in another
order through a 2-layer BERT and ResNet-50); R@K must be equal."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipbert_tpu.ckpt.checkpoint import ModelSaver
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.core.config import RunConfig as JRunConfig
from clipbert_tpu.core.mesh import make_mesh
from clipbert_tpu.core.rng import RngGen
from clipbert_tpu.data import store as j_store
from clipbert_tpu.data.datasets import VideoRetrievalEvalDataset as JEvalDs
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.tasks import run_video_retrieval as j_rvr
from clipbert_tpu.train import steps as j_steps
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.data import store, tokenization, video
from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.train import steps

TOL = dict(rtol=2e-4, atol=2e-5)
WORDS = ["a", "cat", "dog", "runs", "the", "red", "car", "man", "sings"]
MODEL_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8, num_labels=2,
                loss_type="ce", score_agg_func="lse")
N_VIDEOS, N_CLIPS, NUM_FRM, IMG = 5, 2, 2, 64


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes gain nothing from a full intra-op pool; two threads
    keep these tests from crowding the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _port(tree, cfg, fold=False):
    model = load_jax_params(clipbert.empty_clipbert(cfg, device="cpu"), tree)
    if fold:
        clipbert.fold_cnn_bn_scales(model)
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tokenizer, JPEG-sequence store of N_VIDEOS seeded videos, a caption
    file with 7 captions (the second video has two), and the weights."""
    root = tmp_path_factory.mktemp("torch_eval")
    tok_dir = root / "tok"
    tok_dir.mkdir()
    tokenization.write_tiny_vocab(str(tok_dir / "vocab.txt"),
                                  extra_tokens=WORDS)
    tok = tokenization.BertTokenizer.from_dir(str(tok_dir))
    rng = np.random.default_rng(11)
    vs = root / "videos.cbpk"
    with store.PackWriter(str(vs)) as w:
        for i in range(N_VIDEOS):
            fr = rng.integers(0, 256, (12, 36, 48, 3)).astype(np.uint8)
            fr[..., i % 3] //= 2
            w.put(f"vid{i}", video.encode_jseq_from_array(fr, fps=4))
    rows = [{"vid_id": f"vid{i}",
             "txt": " ".join(rng.choice(WORDS, size=rng.integers(2, 6)))}
            for i in [0, 1, 1, 2, 3, 4, 2]]
    txt = root / "val.jsonl"
    txt.write_text("".join(json.dumps(r) + "\n" for r in rows))
    kw = dict(MODEL_KW, vocab_size=len(tok))
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    params = random_params(jcfg, 3)
    return {"root": root, "tok_dir": tok_dir, "tok": tok, "store": vs,
            "txt": txt, "rows": rows, "jcfg": jcfg, "cfg": cfg,
            "params": params}


RUN_KW = dict(loss_type="ce", num_labels=2, inference_n_clips=N_CLIPS,
              num_frm=NUM_FRM, max_img_size=IMG, max_txt_len=8, fps=4,
              score_agg_func="lse", inference_batch_size=4,
              inference_video_batch_size=2, n_workers=1)


def _datalist(rows):
    return [dict(r, id=i) for i, r in enumerate(rows)]


_DS_KW = dict(num_frm=NUM_FRM, max_img_size=IMG, max_txt_len=8, fps=4,
              ensemble_n_clips=N_CLIPS)


@pytest.fixture(scope="module")
def jax_eval(world):
    """The JAX runner's result on the store, per preprocess path, computed
    once for the tests that compare with it."""
    cache = {}

    def get(device_preprocess):
        if device_preprocess not in cache:
            jds = JEvalDs(_datalist(world["rows"]), world["tok"],
                          j_store.open_store(str(world["store"])),
                          device_preprocess=device_preprocess, **_DS_KW)
            cache[device_preprocess] = j_rvr.inference_retrieval(
                JRunConfig(model_config="", **RUN_KW), world["jcfg"],
                j_clipbert.fold_cnn_bn_scales(world["params"]), jds,
                make_mesh(), jnp.float32)
        return cache[device_preprocess]

    return get


@pytest.mark.parametrize("group_size", [1, 2])
def test_mil_forward_matches_jax(world, rng_np, group_size):
    """The bench unit, eval form: clip-major folding of (B_v, nc * nf)
    visuals and per-clip tiling of the texts."""
    jcfg, cfg, params = world["jcfg"], world["cfg"], world["params"]
    B_v, nc = 2, 3
    vis = rng_np.standard_normal((B_v, nc * NUM_FRM, IMG, IMG, 3)).astype(
        np.float32)
    B_t = B_v * group_size
    ids = rng_np.integers(1, jcfg.vocab_size, (B_t, 6))
    mask = np.ones((B_t, 6), np.int64)
    mask[:, 4:] = 0
    jts = j_steps.TaskSettings(head_type="retrieval", num_labels=2,
                               loss_type="ce", score_agg_func="lse",
                               train_n_clips=nc, group_size=group_size)
    want = np.asarray(j_steps.mil_forward(
        params, jcfg, jts, {"visual_inputs": jnp.asarray(vis),
                            "text_input_ids": jnp.asarray(ids, jnp.int32),
                            "text_input_mask": jnp.asarray(mask, jnp.int32)},
        RngGen(None), False, jnp.float32))
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse", train_n_clips=nc,
                            group_size=group_size)
    model = _port(params, cfg)
    batch = {"visual_inputs": torch.from_numpy(vis),
             "text_input_ids": torch.from_numpy(ids),
             "text_input_mask": torch.from_numpy(mask)}
    got = steps.mil_forward(model, cfg, ts, batch, torch.float32).numpy()
    assert got.shape == (B_t, nc, 2)
    np.testing.assert_allclose(got, want, **TOL)
    # clip-major order, checked independently: clip c of video v paired
    # with text t is the plain per-clip forward of that one clip
    t, c = B_t - 1, nc - 1
    v = t // group_size
    one = clipbert.clipbert_forward(
        model, cfg, {"visual_inputs": torch.from_numpy(
            vis[v, c * NUM_FRM:(c + 1) * NUM_FRM][None]),
            "text_input_ids": torch.from_numpy(ids[t:t + 1]),
            "text_input_mask": torch.from_numpy(mask[t:t + 1])},
        "retrieval", compute_dtype=torch.float32)["logits"]
    np.testing.assert_allclose(got[t, c], one[0].numpy(), **TOL)


@pytest.mark.parametrize("device_preprocess", [True, False])
def test_inference_retrieval_matches_jax(world, jax_eval, device_preprocess):
    """The full score matrix and R@K against the JAX runner on the same
    store: 5 videos in groups of 2 (the last group short, its item
    repeated) and 7 captions in minibatches of 4 (the last one ragged);
    native frames resized on the device, or resized and padded on the
    host."""
    rows = world["rows"]
    want = jax_eval(device_preprocess)
    ds = VideoRetrievalEvalDataset(_datalist(rows), world["tok"],
                                   store.open_store(str(world["store"])),
                                   device_preprocess=device_preprocess,
                                   **_DS_KW)
    stats = {}
    got = rvr.inference_retrieval(RunConfig(model_config="", **RUN_KW),
                                  world["cfg"],
                                  _port(world["params"], world["cfg"], True),
                                  ds, torch.float32, stats)
    assert got["score_matrix"].shape == (N_VIDEOS, len(rows))
    np.testing.assert_allclose(got["score_matrix"], want["score_matrix"],
                               **TOL)
    for k in want:
        if k != "score_matrix":
            assert got[k] == want[k], k
    assert stats["n_groups"] == 3 and ds.n_fallbacks == 0
    assert set(stats) == {"setup_s", "data_wait_s", "dispatch_s", "fetch_s",
                          "n_groups", "decode_s", "put_s", "n_videos"}
    assert stats["n_videos"] == N_VIDEOS


def test_cli_runs_a_jax_deploy_checkpoint(world, jax_eval, tmp_path,
                                          monkeypatch):
    """``main --do_inference 1 --device cpu`` on a model_step_N.npz written
    by the JAX package's ModelSaver: the metrics file is written and the
    scores equal the JAX runner's on the same checkpoint."""
    out = tmp_path / "run"
    ModelSaver(str(out)).save(7, world["params"])
    mcfg = tmp_path / "model.json"
    mcfg.write_text(json.dumps(world["cfg"].to_dict()))
    flags = {"model_config": mcfg, "tokenizer_dir": world["tok_dir"],
             "output_dir": out, "inference_txt_db": world["txt"],
             "inference_img_db": world["store"], "bf16": 0, "device": "cpu",
             **RUN_KW}
    argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    got = rvr.main(["--do_inference", "1"] + argv)
    written = json.loads((out / "retrieval_metrics_step7.json").read_text())
    assert written == {k: v for k, v in got.items() if k != "score_matrix"}
    # RunConfig's default is device_preprocess=True
    np.testing.assert_allclose(got["score_matrix"],
                               jax_eval(True)["score_matrix"], **TOL)
    # without --do_inference, main trains (tests/test_torch_train_trainer.py)
    calls = []
    monkeypatch.setattr(rvr, "start_training", lambda cfg: calls.append(cfg))
    rvr.main(argv)
    assert len(calls) == 1 and not calls[0].do_inference
