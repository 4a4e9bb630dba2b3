"""MSRVTT multiple-choice test (port of clipbert_tpu/tasks/run_msrvtt_mc.py):
inference only, on a retrieval checkpoint (reference
`src/tasks/run_msrvtt_mc.py`: scores each of 5 candidate captions with the
retrieval head and takes the argmax probability :190-197, accuracy via the
dataset :237).

One process drives one device; under a process group each process scores
its share of the questions (the eval loader's sampler) and the predictions
merge on every process.

Annotation jsonl rows: {"id", "vid_id", "options": [5 captions],
"answer": int}.

    python -m clipbert_tpu_torch.tasks.run_msrvtt_mc \\
        --config configs/msrvtt_ret_base_resnet50.json --do_inference 1 \\
        --output_dir <dir with model_step_N.npz> \\
        --inference_txt_db <mc.jsonl> --inference_img_db <store> \\
        [--device cpu]
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import numpy as np

from clipbert_tpu_torch.core.config import (ModelConfig, RunConfig,
                                            inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.core.mesh import maybe_init_distributed
from clipbert_tpu_torch.data import datasets
from clipbert_tpu_torch.data.datasets import MSRVTTMCEvalDataset
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import common
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils.basic import load_jsonl, save_json

LOGGER = logging.getLogger(__name__)
N_OPTIONS = 5


def inference_mc(cfg: RunConfig, model_cfg: ModelConfig,
                 model: clipbert.ClipBert, ds: MSRVTTMCEvalDataset,
                 compute_dtype, eval_fn: Optional[Callable] = None
                 ) -> Dict:
    """Each video's 5 options scored as retrieval captions (every clip of
    ``inference_n_clips`` paired with every option), pooled over clips by
    cfg.score_agg_func; the prediction is the option of highest positive
    probability (softmax for ce heads, sigmoid for rank heads). ``eval_fn``
    replaces the default :func:`steps.make_eval_step` (the kernels on a CUDA
    device), e.g. to pick the attention core."""
    device = next(model.parameters()).device
    ts = steps.TaskSettings(
        head_type="retrieval", num_labels=cfg.num_labels,
        loss_type=cfg.loss_type, score_agg_func=cfg.score_agg_func,
        train_n_clips=cfg.inference_n_clips, group_size=N_OPTIONS)
    if eval_fn is None:
        eval_fn = steps.make_eval_step(model_cfg, ts, compute_dtype)
    coll = datasets.RetrievalCollator(ds.tokenizer, cfg.max_txt_len)
    dl = common.build_eval_loader(ds, coll, cfg,
                                  batch_size=cfg.inference_batch_size)
    preds = {}
    # deferred fetches: a D2H copy starts per batch and the conversion runs
    # in a sliding window (common.drain_pending), so the decode and dispatch
    # of batch i+1 overlap batch i's compute

    def convert(entry):
        host, fetch = entry
        logits = fetch.numpy()                    # (B_v*5, num_labels)
        if cfg.loss_type == "ce":
            e = np.exp(logits - logits.max(-1, keepdims=True))
            prob = (e / e.sum(-1, keepdims=True))[:, 1]
        else:
            prob = 1.0 / (1.0 + np.exp(-logits[:, 0]))
        prob = prob.reshape(-1, N_OPTIONS)
        qids = host["question_ids"][::N_OPTIONS]
        for qid, p in zip(qids, prob.argmax(-1)):
            preds[qid] = int(p)

    pending = []
    for batch in dl:
        dev, host = common.device_batch(batch, device, cfg=cfg,
                                        compute_dtype=compute_dtype)
        out = eval_fn(model, dev)
        pending.append((host, common.HostFetch(out["logits"])))
        common.drain_pending(pending, convert)
    common.drain_pending(pending, convert, limit=0)
    gathered = dist.all_gather_objects(preds)
    merged = {k: v for rank in gathered for k, v in rank.items()}
    metrics = ds.evaluate_qa_accuracy(merged, force_same=True)
    metrics["preds"] = merged
    return metrics


def start_inference(cfg: RunConfig) -> Dict:
    if not cfg.do_inference:
        raise SystemExit("clipbert_tpu_torch.tasks.run_msrvtt_mc is "
                         "inference-only (--do_inference 1)")
    cfg = common.restore_inference_config(cfg)
    cfg.do_inference = True
    tokenizer = common.setup_tokenizer(cfg)
    cfg.num_labels = 2 if cfg.loss_type == "ce" else 1
    model_cfg = inject_task_attrs(common.load_model_config(cfg), cfg)
    compute_dtype = common.compute_dtype_for(cfg)
    model, step = common.load_inference_params(cfg, model_cfg, "retrieval")

    raw = load_jsonl(cfg.inference_txt_db)
    ds = MSRVTTMCEvalDataset(
        raw, tokenizer, common.setup_store(cfg.inference_img_db),
        fps=cfg.fps, num_frm=cfg.num_frm, max_img_size=cfg.max_img_size,
        max_txt_len=cfg.max_txt_len, ensemble_n_clips=cfg.inference_n_clips,
        device_preprocess=cfg.device_preprocess)
    metrics = inference_mc(cfg, model_cfg, model, ds, compute_dtype)
    if dist.is_main_process() and cfg.output_dir:
        save_json({k: v for k, v in metrics.items() if k != "preds"},
                  os.path.join(cfg.output_dir,
                               f"mc_metrics_step{step}.json"))
        LOGGER.info({k: v for k, v in metrics.items() if k != "preds"})
    return metrics


def main(argv=None) -> Dict:
    cfg = load_run_config(argv)
    # join the launch's process group before the device is first touched
    maybe_init_distributed(cfg)
    return start_inference(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
