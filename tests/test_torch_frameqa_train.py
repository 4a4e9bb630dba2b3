"""The port's frameqa training against the JAX package's, and the
pretrain-to-finetune handoff, on the CPU, on tests/test_torch_qa_train.py's
world: ``run_video_qa --task frameqa`` (open-ended, LSE over 2 clips)
trains through ``main --device cpu`` from the same init with every step's
loss equal to the JAX trainer's; and a pretraining deploy checkpoint, the
port's or the JAX package's, warm-starts the port's VQA run, as
tests/test_tasks_e2e.py::test_pretrain_to_finetune_handoff does for JAX.
Sizes and tolerances as in tests/test_torch_qa_train.py; the handed-over
trunk bit-equal."""

import numpy as np
import pytest
import torch

from clipbert_tpu.ckpt import checkpoint as j_checkpoint
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import model_state, to_jax_flat
from clipbert_tpu_torch.core.config import ModelConfig, load_run_config
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import run_vqa
from clipbert_tpu_torch.train import trainer
from test_torch_qa_train import (ANSWERS, MODEL_KW,  # noqa: F401
                                 _few_torch_threads, _run_json,
                                 check_trainer_against_jax, jax_tree,
                                 loss_logs, world)


def test_trainer_losses_equal_jax(world, tmp_path, loss_logs):
    check_trainer_against_jax(world, "frameqa", tmp_path, loss_logs)


@pytest.fixture(scope="module")
def fresh_vqa(world, tmp_path_factory):
    """The VQA run's seeded init with no warm start (flattened), made once
    for both handoff cases: what the classifier must keep."""
    path = _run_json(world, "vqa", tmp_path_factory.mktemp("fresh") / "out",
                     e2e_weights_path="", num_train_epochs=1)
    cfg = load_run_config(["--config", path])
    mcfg = ModelConfig.from_json(cfg.model_config).replace(
        num_labels=len(ANSWERS), loss_type="bce")
    return to_jax_flat(model_state(trainer.setup_model(cfg, mcfg, "seq_cls",
                                                       "cpu")))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_pretrain_to_finetune_handoff(world, source, tmp_path, loss_logs,
                                      fresh_vqa):
    """A pretraining deploy checkpoint (written by the port's ModelSaver
    from a port pretrain model, or by the JAX package's from a JAX tree)
    as the VQA run's e2e_weights_path: the trunk (CNN and BERT) loads
    verbatim, the pretrain heads are dropped, the VQA classifier keeps its
    fresh seeded init, and the port's VQA runner trains from it."""
    pre_out = str(tmp_path / "pretrain_out")
    step = 7
    if source == "port":
        mcfg = ModelConfig(**dict(MODEL_KW, vocab_size=world["vocab"]))
        model = clipbert.init_clipbert(
            mcfg, "pretrain", generator=torch.Generator().manual_seed(5),
            device="cpu")
        pre_flat = to_jax_flat(model_state(model))
        checkpoint.ModelSaver(pre_out).save(step, pre_flat)
    else:
        jcfg = JModelConfig(**dict(MODEL_KW, vocab_size=world["vocab"]))
        pre_flat = j_checkpoint.flatten_tree(jax_tree(jcfg, "pretrain", 5))
        j_checkpoint.ModelSaver(pre_out).save(step, pre_flat)
    ckpt = f"{pre_out}/model_step_{step}.npz"
    assert any(k.startswith("transformer/cls/") for k in pre_flat)

    path = _run_json(world, "vqa", tmp_path / "vqa_out",
                     e2e_weights_path=ckpt, num_train_epochs=1)
    cfg = load_run_config(["--config", path])
    mcfg = ModelConfig.from_json(cfg.model_config).replace(
        num_labels=len(ANSWERS), loss_type="bce")
    got = to_jax_flat(model_state(trainer.setup_model(cfg, mcfg, "seq_cls",
                                                      "cpu")))
    fresh = fresh_vqa
    trunk = [k for k in got if k.startswith(("cnn/", "transformer/bert/"))]
    assert len(trunk) > 100
    for k in trunk:
        assert np.array_equal(got[k], pre_flat[k]), k
    head = [k for k in got if k.startswith("transformer/classifier/")]
    assert head and not any(k in pre_flat for k in head)
    for k in head:
        assert np.array_equal(got[k], fresh[k]), k
    if source == "port":
        res = run_vqa.main(["--config", path])
        assert res["global_step"] == 1 and len(loss_logs[1].losses) == 1
        assert np.isfinite(loss_logs[1].losses[0])
        assert "overall_acc" in res["history"][-1]["val"]
