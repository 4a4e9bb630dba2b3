"""The port's retrieval trainer on the CPU, end to end on a synthetic
JPEG-sequence store: ``run_video_retrieval.main`` without
``--do_inference`` trains (where it used to refuse), validates through
inference_retrieval every ``valid_steps`` on the live weights (which it
leaves untouched), writes the deploy checkpoints, the restore bundles and
the scalar log, and a second run on the same output_dir resumes at the
saved step with the bundle's weights bit for bit; a stop signal writes a
bundle the next run resumes from. Tiny sizes: 2 layers, hidden 32, 64^2
frames, fp32."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import model_state, to_jax_flat
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import store, tokenization, video
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.utils import logger

WORDS = ["a", "cat", "dog", "runs", "the", "red", "car", "man", "sings"]
N_VIDEOS = 4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """tensorboard missing (as it may be on the GPU machine): the trainer's
    logger writes scalars.jsonl instead, and importing it costs nothing."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(logger, "TB_LOGGER", logger.TensorboardLogger())
    from clipbert_tpu_torch.train import trainer
    monkeypatch.setattr(trainer, "TB_LOGGER", logger.TB_LOGGER)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    tokenization.write_tiny_vocab(str(root / "vocab.txt"),
                                  extra_tokens=WORDS)
    tok = tokenization.BertTokenizer.from_dir(str(root))
    rng = np.random.default_rng(0)
    with store.PackWriter(str(root / "videos.cbpk")) as w:
        for i in range(N_VIDEOS):
            fr = rng.integers(0, 256, (12, 36, 48, 3)).astype(np.uint8)
            w.put(f"vid{i}", video.encode_jseq_from_array(fr, fps=4))
    rows = [{"vid_id": f"vid{i % N_VIDEOS}",
             "txt": " ".join(rng.choice(WORDS, 4))} for i in range(5)]
    (root / "train.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows[:N_VIDEOS]))
    (root / "val.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    mc = ModelConfig(vocab_size=len(tok), hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=64,
                     max_grid_row_position_embeddings=8,
                     max_grid_col_position_embeddings=8)
    (root / "model.json").write_text(json.dumps(mc.to_dict()))
    cfg = {"model_config": str(root / "model.json"),
           "tokenizer_dir": str(root),
           "train_datasets": [{"name": "t", "txt": str(root / "train.jsonl"),
                               "img": str(root / "videos.cbpk")}],
           "val_datasets": [{"name": "v", "txt": str(root / "val.jsonl"),
                             "img": str(root / "videos.cbpk")}],
           "max_txt_len": 8, "max_img_size": 64, "fps": 4, "num_frm": 1,
           "train_n_clips": 2, "inference_n_clips": 2,
           "score_agg_func": "lse", "loss_type": "ce",
           "train_batch_size": 2, "num_train_epochs": 1, "num_valid": 2,
           "min_valid_steps": 1, "save_steps_ratio": 0.5,
           "learning_rate": 1e-3, "cnn_learning_rate": 1e-3,
           "inference_batch_size": 4, "inference_video_batch_size": 2,
           "n_workers": 1, "bf16": 0, "device": "cpu"}
    (root / "run.json").write_text(json.dumps(cfg))
    return root


def _argv(world, out, **flags):
    argv = ["--config", str(world / "run.json"), "--output_dir", str(out)]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def test_main_trains_validates_saves_and_resumes(world, tmp_path,
                                                 monkeypatch):
    seen = []
    real = rvr.inference_retrieval

    def validate(cfg, model_cfg, model, ds, dtype, *a, **k):
        before = {n: t.clone() for n, t in model_state(model).items()}
        out = real(cfg, model_cfg, model, ds, dtype, *a, **k)
        after = model_state(model)
        assert after.keys() == before.keys()       # no BN folded away
        assert all(torch.equal(after[n], t) for n, t in before.items())
        seen.append(out["t2v_r1"])
        return out

    monkeypatch.setattr(rvr, "inference_retrieval", validate)
    out = tmp_path / "run"
    res = rvr.main(_argv(world, out))
    # 4 captions, one a training item, / batch 2 = 2 steps in the one
    # epoch; validate every ceil(2 / 2 / 1) = 1 step, save every 0.5 * 2
    assert res["global_step"] == 2
    assert [h["step"] for h in res["history"]] == [1, 2] and len(seen) == 2
    losses = [h["loss"] for h in res["history"]]
    assert all(np.isfinite(losses))
    assert checkpoint.ModelSaver(str(out)).available_steps() == [1, 2]
    final = to_jax_flat(model_state(res["model"]))
    deployed = checkpoint.load_flat(str(out / "model_step_2.npz"))
    assert deployed.keys() == final.keys()
    assert all(np.array_equal(deployed[k], final[k]) for k in final)
    first = checkpoint.load_flat(str(out / "model_step_1.npz"))
    assert any(not np.array_equal(first[k], final[k]) for k in final)
    scalars = [json.loads(x) for x in
               (out / "log" / "scalars.jsonl").read_text().splitlines()]
    assert {s["tag"] for s in scalars} >= {"train_train_loss",
                                           "train_grad_norm",
                                           "valid_t2v_r1"}
    assert (out / "log" / "args.json").exists() and \
        (out / "code.zip").exists()

    # the same run again: auto-resumes at step 2 (nothing left to train)
    res2 = rvr.main(_argv(world, out))
    assert res2["global_step"] == 2 and res2["history"] == []
    resumed = to_jax_flat(model_state(res2["model"]))
    assert all(np.array_equal(resumed[k], final[k]) for k in final)
    assert res2["state"].opt.step == 2


def test_stop_signal_bundle_and_resume(world, tmp_path):
    out = tmp_path / "run"
    cfg = rvr.load_run_config(_argv(world, out))
    polls = []

    def stop():
        polls.append(1)
        return len(polls) > 1           # after the first step

    res = rvr.start_training(cfg, stop_signal=stop)
    assert res["global_step"] == 1
    step, tree = checkpoint.TrainingRestorer(str(out), 1).restore()
    assert step == 1 and int(tree["opt"]["step"]) == 1
    bundle = to_jax_flat(model_state(res["model"]))
    flat = checkpoint.flatten_tree(tree["params"])
    assert all(np.array_equal(flat[k], bundle[k]) for k in bundle)
    cfg = rvr.load_run_config(_argv(world, out))
    res = rvr.start_training(cfg, max_steps=2)
    assert res["global_step"] == 2 and res["state"].opt.step == 2


def test_trace_window_writes_a_trace(tmp_path):
    """utils/profiling.py::TraceWindow: a torch.profiler trace of steps
    [start, stop) as a Chrome trace; outside the window nothing runs."""
    from clipbert_tpu_torch.utils.profiling import StepTimer, TraceWindow
    trace = TraceWindow(str(tmp_path), start_step=1, num_steps=2)
    timer = StepTimer()
    for step in range(4):
        trace.maybe_start(step)
        timer.start()
        torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop()
        trace.maybe_stop(step + 1)
    trace.close()
    assert os.listdir(tmp_path) == ["trace_steps_1-3.json"]
    events = json.loads((tmp_path / "trace_steps_1-3.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    assert timer.summary()["steps_per_sec"] > 0
