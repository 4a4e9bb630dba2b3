"""VQA 2.0 image-QA inference (port of clipbert_tpu/tasks/run_vqa.py,
``--do_inference 1`` only).

Capability match for the reference's `src/tasks/run_vqa.py`: a bce
classifier over the answer vocabulary (3129 answers), VQA-score validation
with the answer-type breakdown (:172-243), inference replaying the stored
training args (:466-477). On a CUDA device the CNN runs its kernel form
and the attention core the fused kernel. Training is a later slice of the
port: ``main`` refuses it.

Annotation jsonl: {"question_id", "txt", "img_id" (or "vid_id"),
"labels": {ans: score}, "answer_type"}; the ans2label json maps answer ->
index.

    python -m clipbert_tpu_torch.tasks.run_vqa \\
        --config configs/vqa_base_resnet50.json --do_inference 1 \\
        --output_dir <dir with model_step_N.npz> \\
        [--inference_txt_db <jsonl> --inference_img_db <store>] \\
        [--device cpu]
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List

from clipbert_tpu_torch.core.config import (RunConfig, inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.core.mesh import maybe_init_distributed
from clipbert_tpu_torch.data import datasets, transforms
from clipbert_tpu_torch.data.datasets import VQADataset
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import common
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils.basic import load_json, load_jsonl, save_json

LOGGER = logging.getLogger(__name__)


def build_datalist(ann_paths: List[str], data_ratio: float, is_train: bool,
                   max_n_example_per_group: int, seed: int = 42):
    raw = []
    for p in ann_paths:
        raw.extend(load_jsonl(p))
    key = "img_id" if raw and "img_id" in raw[0] else "vid_id"
    grouped = datasets.group_datalist_by_visual(raw, key)
    groups = transforms.mk_input_group(
        grouped,
        max_n_example_per_group=max_n_example_per_group if is_train else 1,
        is_train=is_train)
    return datasets.apply_data_ratio(groups, data_ratio, seed)


def make_task_settings(cfg: RunConfig, is_train: bool = True
                       ) -> steps.TaskSettings:
    return steps.TaskSettings(
        head_type="seq_cls", num_labels=cfg.num_labels, loss_type="bce",
        train_n_clips=1,
        group_size=cfg.max_n_example_per_group if is_train else 1)


def build_validate(cfg: RunConfig, val_ds: VQADataset, val_loader,
                   compute_dtype) -> Callable:
    """validate(model, eval_fn) -> the VQA metrics of ``val_ds`` plus
    ``results`` [{"question_id", "answer" (the answer string)}], every
    process's predictions merged. ``eval_fn`` is a
    :func:`steps.make_eval_step`."""

    def validate(model: clipbert.ClipBert, eval_fn: Callable) -> Dict:
        device = next(model.parameters()).device
        # deferred fetches (a D2H copy per batch, converted in a sliding
        # window, common.drain_pending) keep the host decoding and
        # dispatching without retaining every batch's (B, num_labels)
        # device logits until the loop ends
        results = []

        def convert(entry):
            qids, fetch = entry
            preds = fetch.numpy().argmax(-1)
            for qid, p in zip(qids, preds):
                results.append({"question_id": qid,
                                "answer": val_ds.label2ans[int(p)]})

        pending = []
        for batch in val_loader:
            dev, host = common.device_batch(batch, device, cfg=cfg,
                                            compute_dtype=compute_dtype)
            out = eval_fn(model, dev)
            pending.append((host["question_ids"],
                            common.HostFetch(out["logits"])))
            common.drain_pending(pending, convert)
        common.drain_pending(pending, convert, limit=0)
        gathered = [r for rank in dist.all_gather_objects(results)
                    for r in rank]
        metrics = val_ds.evaluate_vqa(gathered)
        metrics["results"] = gathered
        return metrics

    return validate


def start_inference(cfg: RunConfig) -> Dict:
    cfg = common.restore_inference_config(cfg)
    tokenizer = common.setup_tokenizer(cfg)
    ans2label = load_json(cfg.ans2label_path)
    cfg.num_labels = len(ans2label)
    model_cfg = inject_task_attrs(common.load_model_config(cfg), cfg)
    compute_dtype = common.compute_dtype_for(cfg)
    model, step = common.load_inference_params(cfg, model_cfg, "seq_cls")

    txt = cfg.inference_txt_db or cfg.val_datasets[0].txt_paths()[0]
    img = cfg.inference_img_db or cfg.val_datasets[0].img
    groups = build_datalist([txt] if isinstance(txt, str) else txt,
                            1.0, False, 1, cfg.seed)
    ds = VQADataset(groups, tokenizer, common.setup_store(img),
                    ans2label=ans2label, max_img_size=cfg.max_img_size,
                    max_txt_len=cfg.max_txt_len,
                    device_preprocess=cfg.device_preprocess)
    dl = common.build_eval_loader(
        ds, datasets.RetrievalCollator(tokenizer, cfg.max_txt_len), cfg,
        batch_size=cfg.inference_batch_size)
    eval_fn = steps.make_eval_step(
        model_cfg, make_task_settings(cfg, is_train=False), compute_dtype)
    metrics = build_validate(cfg, ds, dl, compute_dtype)(model, eval_fn)
    if dist.is_main_process() and cfg.output_dir:
        save_json(metrics.get("results", []),
                  os.path.join(cfg.output_dir,
                               f"vqa_results_step{step}.json"))
        LOGGER.info({k: v for k, v in metrics.items() if k != "results"})
    return metrics


def main(argv=None) -> Dict:
    cfg = load_run_config(argv)
    # join the launch's process group before the device is first touched
    maybe_init_distributed(cfg)
    if not cfg.do_inference:
        raise SystemExit(
            "clipbert_tpu_torch.tasks.run_vqa runs inference only "
            "(--do_inference 1); VQA training is not ported yet (train "
            "with clipbert_tpu.tasks.run_vqa)")
    return start_inference(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
