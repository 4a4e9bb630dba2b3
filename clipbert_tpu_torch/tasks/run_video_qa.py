"""Video QA inference: TGIF-QA (action / transition / frameqa) and
MSRVTT-QA (port of clipbert_tpu/tasks/run_video_qa.py,
``--do_inference 1`` only).

Capability match for the reference's `src/tasks/run_video_qa.py`: MC tasks
concatenate question and option into 5 texts per question (:206-213,
collator :201-205) scored by the multi-choice head, open-ended tasks
classify over ans2label (:166-176); validation pools per-clip logits over
``inference_n_clips`` clips and scores the TGIF metrics with cross-process
gathering (:216-362). On a CUDA device the CNN runs its kernel form and
the attention core the fused kernel. Training is a later slice of the
port: ``main`` refuses it.

Annotation jsonl rows: {"vid_id", "question", "question_id", "answer",
"options"? (MC), "answer_type"? (open-ended)}.

    python -m clipbert_tpu_torch.tasks.run_video_qa \\
        --config configs/tgif_qa_action_base_resnet50.json \\
        --do_inference 1 --output_dir <dir with model_step_N.npz> \\
        [--inference_txt_db <jsonl> --inference_img_db <store>] \\
        [--device cpu]
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict

from clipbert_tpu_torch.core.config import (RunConfig, inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.core.mesh import maybe_init_distributed
from clipbert_tpu_torch.data import datasets, transforms
from clipbert_tpu_torch.data.datasets import OPEN_ENDED_QA, VideoQADataset
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import common
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils.basic import load_json, load_jsonl, save_json

LOGGER = logging.getLogger(__name__)
MC_TASKS = ("action", "transition")
N_OPTIONS = 5


def derive_task_attrs(cfg: RunConfig, ans2label) -> RunConfig:
    """task -> num_labels / loss_type (reference config.py:359-369)."""
    if cfg.task in MC_TASKS:
        cfg.num_labels = N_OPTIONS
        cfg.loss_type = "ce"
    else:
        if ans2label is None:
            raise ValueError(f"open-ended task {cfg.task!r} needs "
                             "ans2label_path")
        cfg.num_labels = len(ans2label)
        cfg.loss_type = "ce"
    return cfg


def make_task_settings(cfg: RunConfig, n_clips: int) -> steps.TaskSettings:
    if cfg.task in MC_TASKS:
        head, G = "multi_choice", N_OPTIONS
    else:
        head, G = "seq_cls", 1
    return steps.TaskSettings(
        head_type=head, num_labels=cfg.num_labels, loss_type=cfg.loss_type,
        score_agg_func=cfg.score_agg_func, train_n_clips=n_clips,
        group_size=G)


def build_groups(cfg: RunConfig, ann_paths, is_train: bool):
    if isinstance(ann_paths, str):
        ann_paths = [ann_paths]
    raw = []
    for p in ann_paths:
        raw.extend(load_jsonl(p))
    grouped = datasets.group_datalist_by_visual(raw, "vid_id")
    # one question per group keeps B_t = B_v * G static for MC and open-ended
    groups = transforms.mk_input_group(grouped, max_n_example_per_group=1,
                                       is_train=is_train)
    if is_train:
        groups = datasets.apply_data_ratio(groups, cfg.data_ratio, cfg.seed)
    return groups


def build_dataset(cfg: RunConfig, groups, tokenizer, store, ans2label,
                  is_train: bool, n_clips: int) -> VideoQADataset:
    return VideoQADataset(
        cfg.task, groups, tokenizer, store, ans2label=ans2label,
        fps=cfg.fps, num_frm=cfg.num_frm,
        frm_sampling_strategy=cfg.frm_sampling_strategy,
        max_img_size=cfg.max_img_size, max_txt_len=cfg.max_txt_len,
        ensemble_n_clips=n_clips, is_train=is_train,
        random_sample_clips=cfg.random_sample_clips, n_options=N_OPTIONS,
        seed=cfg.seed, device_preprocess=cfg.device_preprocess)


def build_validate(cfg: RunConfig, val_ds: VideoQADataset, val_loader,
                   compute_dtype) -> Callable:
    """validate(model, eval_fn) -> the TGIF metrics of ``val_ds`` plus
    ``results`` [{"question_id", "answer" (label index)}], every process's
    predictions merged. ``eval_fn`` is a :func:`steps.make_eval_step`."""

    def validate(model: clipbert.ClipBert, eval_fn: Callable) -> Dict:
        device = next(model.parameters()).device
        # deferred fetches: a D2H copy starts per batch and the conversion
        # runs in a sliding window (common.drain_pending), so the host keeps
        # decoding and dispatching instead of blocking on each batch
        results = []

        def convert(entry):
            qids, fetch = entry
            preds = fetch.numpy().argmax(-1)
            for qid, p in zip(qids, preds):
                results.append({"question_id": qid, "answer": int(p)})

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
        metrics = val_ds.evaluate_tgif_qa(gathered)
        metrics["results"] = gathered
        return metrics

    return validate


def start_inference(cfg: RunConfig) -> Dict:
    cfg = common.restore_inference_config(cfg)
    tokenizer = common.setup_tokenizer(cfg)
    ans2label = (load_json(cfg.ans2label_path)
                 if cfg.task in OPEN_ENDED_QA else None)
    cfg = derive_task_attrs(cfg, ans2label)
    model_cfg = inject_task_attrs(common.load_model_config(cfg), cfg)
    compute_dtype = common.compute_dtype_for(cfg)
    head = "multi_choice" if cfg.task in MC_TASKS else "seq_cls"
    model, step = common.load_inference_params(cfg, model_cfg, head)

    txt = (cfg.inference_txt_db
           or cfg.val_datasets[0].txt_paths(cfg.task)[0])
    img = cfg.inference_img_db or cfg.val_datasets[0].img
    ds = build_dataset(cfg, build_groups(cfg, txt, False), tokenizer,
                       common.setup_store(img), ans2label, False,
                       cfg.inference_n_clips)
    dl = common.build_eval_loader(
        ds, datasets.VideoQACollator(tokenizer, cfg.max_txt_len), cfg,
        batch_size=cfg.inference_batch_size)
    eval_fn = steps.make_eval_step(
        model_cfg, make_task_settings(cfg, cfg.inference_n_clips),
        compute_dtype)
    metrics = build_validate(cfg, ds, dl, compute_dtype)(model, eval_fn)
    if dist.is_main_process() and cfg.output_dir:
        save_json({k: v for k, v in metrics.items() if k != "results"},
                  os.path.join(cfg.output_dir,
                               f"videoqa_{cfg.task}_metrics_step{step}.json"))
        save_json(metrics.get("results", []),
                  os.path.join(cfg.output_dir,
                               f"videoqa_{cfg.task}_results_step{step}.json"))
        LOGGER.info({k: v for k, v in metrics.items() if k != "results"})
    return metrics


def main(argv=None) -> Dict:
    cfg = load_run_config(argv)
    # join the launch's process group before the device is first touched
    maybe_init_distributed(cfg)
    if not cfg.do_inference:
        raise SystemExit(
            "clipbert_tpu_torch.tasks.run_video_qa runs inference only "
            "(--do_inference 1); video-QA training is not ported yet "
            "(train with clipbert_tpu.tasks.run_video_qa)")
    return start_inference(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
