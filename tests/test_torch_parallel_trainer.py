"""Training across processes, continued (tests/test_torch_parallel_train.py
has the retrieval steps): the pretraining step (MLM + ITM) under a
2-rank group, data-parallel (2 x 1) and tensor-parallel (1 x 2), against
the JAX make_train_step on the global batch, with the bounds of that file;
and the retrieval trainer across 2 processes against one process.

One 2-rank gloo group runs the two steps and then the trainer
(``run_video_retrieval.main(... --num_processes 2 ...)``), while this
process compiles the JAX step and runs the one-process trainer. The
trainer's store holds static videos (every frame alike), so whichever
frames a process samples the pixels are the same, and no ITM negatives
(their draws depend on how many items a process has loaded); dropout is
0, and tensorboard is hidden (its import costs seconds) so the scalars go
to log/scalars.jsonl."""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu_torch.data import store, tokenization, video
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.train import steps, trainer
from clipbert_tpu_torch.utils import logger
from test_torch_heads import random_params
from test_torch_parallel_train import (LOSS_TOL, MODEL_KW, _jax_update,
                                       check_case, run_groups, step_job)
from test_torch_pretrain import _step_batch

PRE_TS = dict(head_type="pretrain", group_size=2)
WORDS = ["a", "cat", "dog", "runs", "the", "red", "car", "man", "sings"]
EVAL_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_torch_parallel.py


def _trainer_world(root):
    tokenization.write_tiny_vocab(str(root / "vocab.txt"),
                                  extra_tokens=WORDS)
    tok = tokenization.BertTokenizer.from_dir(str(root))
    rng = np.random.default_rng(0)
    with store.PackWriter(str(root / "videos.cbpk")) as w:
        for i in range(4):
            fr = rng.integers(0, 256, (1, 36, 48, 3)).astype(np.uint8)
            w.put(f"vid{i}", video.encode_jseq_from_array(
                np.repeat(fr, 12, axis=0), fps=4))
    rows = [{"vid_id": f"vid{i % 4}", "txt": " ".join(rng.choice(WORDS, 4))}
            for i in range(5)]
    (root / "train.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows[:4]))
    (root / "val.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    mc = dict(MODEL_KW, vocab_size=len(tok))
    (root / "model.json").write_text(json.dumps(mc))
    cfg = {"model_config": str(root / "model.json"),
           "tokenizer_dir": str(root),
           "train_datasets": [{"name": "t", "txt": str(root / "train.jsonl"),
                               "img": str(root / "videos.cbpk")}],
           "val_datasets": [{"name": "v", "txt": str(root / "val.jsonl"),
                             "img": str(root / "videos.cbpk")}],
           "max_txt_len": 8, "max_img_size": 64, "fps": 4, "num_frm": 1,
           "train_n_clips": 2, "inference_n_clips": 1, "itm_neg_size": 0,
           "score_agg_func": "lse", "loss_type": "ce",
           "num_train_epochs": 1, "num_valid": 2, "min_valid_steps": 1,
           "save_steps_ratio": 1.0, "learning_rate": 1e-3,
           "cnn_learning_rate": 1e-3, "dropout": 0.0,
           "inference_batch_size": 4,
           "inference_video_batch_size": 2, "n_workers": 1, "bf16": 0,
           "device": "cpu"}
    (root / "run.json").write_text(json.dumps(cfg))
    return root


def _trainer_argv(root, out, batch):
    return ["--config", str(root / "run.json"), "--output_dir", str(out),
            "--train_batch_size", str(batch)]




def _one_process_trainer(root, out):
    """The trainer runs of torch_parallel_train_ranks.trainer_run in this
    process, with no process group, at twice the per-process batch: a stop
    after step 1, then start_training(max_steps=2); the per-step losses and
    the validations."""
    mp = pytest.MonkeyPatch()
    losses = []
    making = steps.make_train_step

    def recording(*args, **kwargs):
        step = making(*args, **kwargs)

        def recorded(state, batch, seed):
            state, m = step(state, batch, seed)
            losses.append(float(m["loss"]))
            return state, m
        return recorded

    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(trainer, "TB_LOGGER", logger.TensorboardLogger())
        mp.setattr(steps, "make_train_step", recording)
        polls = []
        first = rvr.start_training(
            rvr.load_run_config(_trainer_argv(root, out, 2)),
            stop_signal=lambda: polls.append(1) or len(polls) > 1)
        n_first = len(losses)
        second = rvr.start_training(
            rvr.load_run_config(_trainer_argv(root, out, 2)), max_steps=2)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return {"losses": [losses[:n_first], losses[n_first:]],
            "steps": [first["global_step"], second["global_step"]],
            "val": [[h.get("val") for h in r["history"]]
                    for r in (first, second)]}


@pytest.fixture(scope="module")
def pre_inputs():
    params = random_params(JModelConfig(**MODEL_KW), "pretrain", 3)
    return (jax.tree.map(np.asarray, params),
            _step_batch(MODEL_KW["vocab_size"], seed=4, b_v=2))


@pytest.fixture(scope="module")
def results(tmp_path_factory, pre_inputs):
    """The 2 ranks' results, and this process's: the JAX reference and the
    one-process trainer's runs."""
    tree, batch = pre_inputs
    root = _trainer_world(tmp_path_factory.mktemp("trainer"))
    groups = {2: [
        step_job("pre_2x1", 1, tree, MODEL_KW, PRE_TS, batch),
        step_job("pre_1x2", 2, tree, MODEL_KW, PRE_TS, batch),
        ("trainer", "trainer_run",
         (_trainer_argv(root, root / "run2", 1),
          str(root / "trainer_rendezvous")))]}

    def local():
        return (_jax_update(tree, batch, PRE_TS, 1),
                _one_process_trainer(root, root / "run1"))

    try:
        out, (ref, one) = run_groups(tmp_path_factory, groups, local)
    finally:
        # the runs' checkpoints and restore bundles: ~1.6 GB
        for run in ("run1", "run2", "run2_rank1"):
            shutil.rmtree(root / run, ignore_errors=True)
    return out, ref, one


@pytest.mark.parametrize("name,shape", [("pre_2x1", (2, 1)),
                                        ("pre_1x2", (1, 2))])
def test_pretrain_step_matches_jax(results, name, shape):
    out, ref, _ = results
    check_case([r[name] for r in out[2]], ref, shape)


def test_mlm_accuracy_is_a_global_ratio(results, pre_inputs):
    """The two halves of the pretrain batch hold different numbers of
    masked positions, so the mean of per-rank accuracies is not the
    global one; the data-parallel step's ``mlm_acc`` is the JAX step's."""
    _, batch = pre_inputs
    counts = (batch["mlm_labels"].reshape(2, -1) != -100).sum(1)
    assert counts[0] != counts[1] and counts.min() > 0
    out, ref, _ = results
    for r in out[2]:
        np.testing.assert_allclose(r["pre_2x1"]["metrics"]["mlm_acc"],
                                   ref["metrics"]["mlm_acc"], **LOSS_TOL)


def test_two_process_trainer(results, record_property):
    """``run_video_retrieval.main(... --num_processes 2 ...)`` at one
    video a process: a gloo group; its per-step losses equal one process
    at two videos a step (a stop after step 1, then a resumed run to step
    2, in both). The stop is asked on rank 0 only and both ranks stop at
    step 1; rank 1's output directory is its own, so only rank 0 finds
    the step-1 bundle, and both resume from it (rank 1 takes rank 0's
    step counts with its weights). Only rank 0 writes; both ranks end
    bit-identical; each validation's merged metrics equal the one
    process's."""
    out, _, one = results
    record_property("spawn_s", round(out["spawn_s"][2], 2))
    r0, r1 = (r["trainer"] for r in out[2])
    assert one["steps"] == [1, 2]
    for r in (r0, r1):
        assert r["backend"] == "gloo"
        assert r["steps"] == [1, 2] and r["opt_step"] == 2
        for got, want in zip(r["losses"], one["losses"]):
            assert len(got) == len(want) == 1
            np.testing.assert_allclose(got, want, **LOSS_TOL)
        for got_run, want_run in zip(r["val"], one["val"]):
            assert len(got_run) == len(want_run) == 1
            for got, want in zip(got_run, want_run):
                np.testing.assert_allclose(got["score_matrix"],
                                           want["score_matrix"], **EVAL_TOL)
                for k in want:
                    if k != "score_matrix":
                        assert got[k] == want[k], k
    assert r0["digest"] == r1["digest"]
    assert r1["writes"] == [] and "restore.npz" not in r1["out_files"]
    kinds = {k for k, _ in r0["writes"]}
    assert {"_write_npz", "save_training_meta", "create"} <= kinds
    assert "restore.npz" in r0["out_files"] and \
        "model_step_2.npz" in r0["out_files"]
