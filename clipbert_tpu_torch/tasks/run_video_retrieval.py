"""Text-to-video retrieval (MSRVTT / DiDeMo / ActivityNet): port of
clipbert_tpu/tasks/run_video_retrieval.py, training and inference.

Training (``--do_inference 0``, the default): MIL over ``train_n_clips``
random clips a video with mean / max / LSE score aggregation
(run_video_retrieval.py:379-421), the clips folded into one batch, one
caption a video with ``itm_neg_size`` random negatives, through
train/trainer.py; every ``valid_steps`` the trainer validates through
:func:`inference_retrieval` on the live weights, which on a CUDA device
runs the port's kernels.

Full-matrix inference: every video scored against every caption, R1/R5/
R10/MedR/MeanR both directions (reference run_video_retrieval.py:519-625,
:628-734). Each video's ``inference_n_clips`` clips are CNN-encoded once
(on a CUDA device through the CNN's kernel form: the fused stem and the
fused 1x1 convs) and the cached grid features are reused across all
caption minibatches, scored through the fused attention kernel.

One process drives one device. Under a process group (torchrun, or the
``--coordinator_address/--num_processes/--process_id`` topology) each
process scores every ``process_count``-th video on its own card and the
rows merge on every process (utils/distributed.py::all_gather_objects),
as the JAX runner shards eval over hosts. Training runs in one process.

Annotation jsonl: train rows {"vid_id", "txt"}; eval rows {"vid_id",
"txt"}, a caption's id being its line index.

    python -m clipbert_tpu_torch.tasks.run_video_retrieval \\
        --config configs/msrvtt_ret_base_resnet50.json [--device cpu]
    python -m clipbert_tpu_torch.tasks.run_video_retrieval \\
        --config configs/msrvtt_ret_base_resnet50.json --do_inference 1 \\
        --output_dir <dir with model_step_N.npz> [--device cpu]
    torchrun --nproc_per_node N -m clipbert_tpu_torch.tasks.\\
        run_video_retrieval <the same flags>
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from clipbert_tpu_torch.core.config import (ModelConfig, RunConfig,
                                            inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.core.mesh import maybe_init_distributed
from clipbert_tpu_torch.data import datasets, transforms
from clipbert_tpu_torch.data.datasets import (VideoRetrievalEvalDataset,
                                              VideoRetrievalTrainDataset)
from clipbert_tpu_torch.evaluation import metrics as eval_metrics
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import common
from clipbert_tpu_torch.train import steps, trainer
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils import profiling
from clipbert_tpu_torch.utils.basic import load_jsonl, save_json

LOGGER = logging.getLogger(__name__)


def make_task_settings(cfg: RunConfig) -> steps.TaskSettings:
    return steps.TaskSettings(
        head_type="retrieval", num_labels=cfg.num_labels,
        loss_type=cfg.loss_type, score_agg_func=cfg.score_agg_func,
        train_n_clips=cfg.train_n_clips,
        group_size=1 + cfg.itm_neg_size, margin=cfg.margin,
        remat=cfg.remat)


def build_train_datalist(cfg: RunConfig, ann_paths):
    if isinstance(ann_paths, str):
        ann_paths = [ann_paths]
    raw = []
    for p in ann_paths:
        raw.extend(load_jsonl(p))
    for i, d in enumerate(raw):
        d.setdefault("id", i)
    grouped = datasets.group_datalist_by_visual(raw, "vid_id")
    # exactly one caption per video per step (each expands to 1 positive +
    # itm_neg_size negatives in the dataset)
    groups = transforms.mk_input_group(grouped, max_n_example_per_group=1,
                                       is_train=True)
    return datasets.apply_data_ratio(groups, cfg.data_ratio, cfg.seed)


def build_val_dataset(cfg: RunConfig, tokenizer):
    """The first val dataset's captions and videos, for the trainer's
    validation, or None."""
    if not cfg.val_datasets:
        return None
    vspec = cfg.val_datasets[0]
    val_raw = load_jsonl(vspec.txt_paths()[0])
    for i, d in enumerate(val_raw):
        d["id"] = i
    return VideoRetrievalEvalDataset(
        val_raw, tokenizer, common.setup_store(vspec.img), fps=cfg.fps,
        num_frm=cfg.num_frm, max_img_size=cfg.max_img_size,
        max_txt_len=cfg.max_txt_len,
        ensemble_n_clips=cfg.inference_n_clips,
        device_preprocess=cfg.device_preprocess)


def start_training(cfg: RunConfig, max_steps: Optional[int] = None,
                   stop_signal=None) -> Dict:
    """Train on the first train dataset (one caption a video a step) and
    validate through :func:`inference_retrieval` on the first val
    dataset; trainer.train's result."""
    tokenizer = common.setup_tokenizer(cfg)
    cfg.num_labels = 2 if cfg.loss_type == "ce" else 1
    model_cfg = inject_task_attrs(common.load_model_config(cfg), cfg)
    compute_dtype = common.compute_dtype_for(cfg)

    tspec = cfg.train_datasets[0]
    groups = build_train_datalist(cfg, tspec.txt_paths())
    train_ds = VideoRetrievalTrainDataset(
        groups, tokenizer, common.setup_store(tspec.img), fps=cfg.fps,
        num_frm=cfg.num_frm, frm_sampling_strategy=cfg.frm_sampling_strategy,
        max_img_size=cfg.max_img_size, max_txt_len=cfg.max_txt_len,
        itm_neg_size=cfg.itm_neg_size, ensemble_n_clips=cfg.train_n_clips,
        random_sample_clips=cfg.random_sample_clips, seed=cfg.seed,
        device_preprocess=cfg.device_preprocess)
    train_loader, steps_per_epoch = common.build_train_loader(
        train_ds, datasets.RetrievalCollator(tokenizer, cfg.max_txt_len), cfg)
    mean, std = common.pixel_mean_std(cfg)
    spec = trainer.TaskSpec(
        name="video_retrieval", head_type="retrieval",
        settings=make_task_settings(cfg), train_loader=train_loader,
        steps_per_epoch=steps_per_epoch, mean=mean, std=std,
        max_img_size=cfg.max_img_size)
    val_ds = build_val_dataset(cfg, tokenizer)
    if val_ds is not None:
        spec.validate_fn = lambda model, _eval_fn: inference_retrieval(
            cfg, model_cfg, model, val_ds, compute_dtype)
    return trainer.train(cfg, model_cfg, spec, max_steps=max_steps,
                         stop_signal=stop_signal)


def _to_device(arr: Optional[np.ndarray], device: torch.device,
               stream: Optional[torch.cuda.Stream]):
    """Host array -> device tensor. On CUDA the copy comes from pinned
    memory on the loader thread's side ``stream``, so it overlaps the
    scoring that the main stream runs meanwhile."""
    if arr is None:
        return None
    t = torch.from_numpy(arr)
    if stream is None:
        return t.to(device)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(device, non_blocking=True)


# stage_stats key -> the span of inference_retrieval it sums
STAGE_SPANS = {"setup_s": "retrieval.setup",
               "data_wait_s": "retrieval.data_wait",
               "dispatch_s": "retrieval.dispatch",
               "fetch_s": "retrieval.fetch",
               "decode_s": "retrieval.decode", "put_s": "retrieval.put"}


def inference_retrieval(cfg: RunConfig, model_cfg: ModelConfig,
                        model: clipbert.ClipBert,
                        eval_ds: VideoRetrievalEvalDataset, compute_dtype,
                        stage_stats: Optional[Dict] = None, *,
                        use_kernels: Optional[bool] = None,
                        fused_attn: Optional[bool] = None) -> Dict:
    """Full (n_videos x n_captions) score matrix with cached visual features.

    Scores are the softmax positive-class probability for ce heads and the
    sigmoid for rank heads (run_video_retrieval.py:679-682), pooled over
    clips by cfg.score_agg_func. Videos are decoded by a threaded loader and
    scored cfg.inference_video_batch_size at a time: (videos x clips x
    texts) fold into one BERT batch, whose attention runs the fused kernel
    on a CUDA device. ``use_kernels`` picks the CNN's form
    (models/resnet.py::resnet50_forward; None: the kernel form on a CUDA
    device).

    Under a process group each process scores videos ``process_index``,
    ``process_index + process_count``, ... on its own device and the rows
    merge through all_gather_objects, so every process returns the whole
    matrix; each video must be scored exactly once.

    ``stage_stats``: optional dict filled from the call's spans
    (utils/profiling.py; ``STAGE_SPANS``) with per-stage wall seconds
    summed over the video loop: ``data_wait_s`` (blocked on decode + H2D
    from the loader threads), ``dispatch_s`` (preprocess/encode/score
    launches; the D2H copies of the scores start in the loop), ``fetch_s``
    (the deferred post-loop wait for the scores, which waits out whatever
    compute is still queued), plus ``setup_s``, ``n_groups`` (the dispatch
    spans), ``n_videos`` and the loader threads' own ``decode_s`` (dataset
    + collate) and ``put_s`` (issuing the H2D copy). The spans of every
    thread are collected while the call runs: give one call at a time a
    ``stage_stats``.
    """
    scope = profiling.collect() if stage_stats is not None \
        else nullcontext()
    with scope as spans, profiling.span("retrieval.call"):
        flat = _score_videos(cfg, model_cfg, model, eval_ds, compute_dtype,
                             use_kernels, fused_attn)
    if stage_stats is not None:
        sums = spans.totals()
        stage_stats.update({k: sums.get(name, {}).get("s", 0.0)
                            for k, name in STAGE_SPANS.items()})
        stage_stats["n_groups"] = sums.get("retrieval.dispatch",
                                           {}).get("n", 0)
        stage_stats["n_videos"] = len(range(dist.process_index(),
                                            len(eval_ds),
                                            dist.process_count()))
    return flat


def _score_videos(cfg, model_cfg, model, eval_ds, compute_dtype,
                  use_kernels, fused_attn):
    """inference_retrieval's work: its metrics."""
    with profiling.span("retrieval.setup"):
        device = next(model.parameters()).device
        on_cuda = device.type == "cuda"
        ts = steps.TaskSettings(head_type="retrieval",
                                loss_type=cfg.loss_type,
                                score_agg_func=cfg.score_agg_func,
                                train_n_clips=cfg.inference_n_clips)
        encode_fn = steps.make_visual_encode_step(compute_dtype, use_kernels)
        prob_fn = steps.make_text_prob_step(model_cfg, ts, compute_dtype,
                                            fused_attn)
        mean, std = common.pixel_mean_std(cfg)

        caps = eval_ds.encode_all_captions()
        n_caps = caps["text_input_ids"].shape[0]
        bsz = cfg.inference_batch_size
        # every minibatch has one fixed shape: the last one repeats its last
        # row and the extra columns are sliced off by n_valid
        cap_batches = []
        for s in range(0, n_caps, bsz):
            ids = caps["text_input_ids"][s:s + bsz]
            mask = caps["text_input_mask"][s:s + bsz]
            n_valid = len(ids)
            if n_valid < bsz:
                pad = bsz - n_valid
                ids = np.concatenate([ids, np.repeat(ids[-1:], pad, 0)])
                mask = np.concatenate([mask, np.repeat(mask[-1:], pad, 0)])
            cap_batches.append((torch.from_numpy(ids).to(device),
                                torch.from_numpy(mask).to(device), n_valid))

        nf = eval_ds.num_frm
        vb = max(1, cfg.inference_video_batch_size)
        videos = list(range(dist.process_index(), len(eval_ds),
                            dist.process_count()))
        groups = [videos[i:i + vb] for i in range(0, len(videos), vb)]
    local = threading.local()

    def load(group):
        with profiling.span("retrieval.decode"):
            items = [eval_ds[v] for v in group]
            items += [items[-1]] * (vb - len(group))   # tail pad, no re-decode
            vis, src_hw = transforms.collate_visual(items)
        stream, ready = None, None
        with profiling.span("retrieval.put"):
            if on_cuda:
                if not hasattr(local, "stream"):
                    local.stream = torch.cuda.Stream(device)
                stream = local.stream
            with torch.cuda.device(device) if on_cuda else nullcontext():
                vis = _to_device(vis, device, stream)
                src_hw = _to_device(src_hw, device, stream)
                if on_cuda:
                    ready = torch.cuda.Event()
                    ready.record(stream)
        return group, vis, src_hw, ready

    # Decode concurrency is clamped to the cores: decode is CPU-bound (the
    # native decoder and PIL release the GIL), threads beyond the cores add
    # no throughput but delay the first group, and the device cannot start
    # until group 0 lands (clipbert_tpu/tasks/run_video_retrieval.py:207-215)
    n_threads = max(1, min(cfg.n_workers, os.cpu_count() or 1))
    rows = []      # (video_idx, scores (n_caps,))
    pending = []   # (group, common.HostFetch of its scores), read after the loop
    with ThreadPoolExecutor(n_threads) as pool:
        batches = pool.map(load, groups)
        while True:
            with profiling.span("retrieval.data_wait"):
                nxt = next(batches, None)
            if nxt is None:
                break
            with profiling.span("retrieval.dispatch"):
                group, vis, src_hw, ready = nxt
                if ready is not None:
                    main = torch.cuda.current_stream(device)
                    main.wait_event(ready)
                    for t in (vis, src_hw):
                        if t is not None:
                            t.record_stream(main)
                # vis: (vb, n_clips*nf, H, W, 3) uint8 -> (vb*nc, nf, S, S, 3)
                nc = vis.shape[1] // nf
                if src_hw is not None:
                    pixels = transforms.resize_pad_normalize(
                        vis, src_hw, cfg.max_img_size, mean, std,
                        compute_dtype)
                else:
                    pixels = transforms.normalize_pixels(vis, mean, std,
                                                         compute_dtype)
                pixels = pixels.reshape((vb * nc, nf) + pixels.shape[2:])
                feats = encode_fn(model, pixels)       # once per video
                del vis, src_hw, pixels
                feats = feats.reshape((vb, nc) + feats.shape[1:])
                scores_dev = torch.cat([prob_fn(model, feats, ids, mask)
                                        [:, :n_valid]
                                        for ids, mask, n_valid in cap_batches],
                                       dim=1)
                del feats
                # start the D2H copy without blocking the loop: the next
                # group's launches overlap this group's compute, and the
                # deferred fetch below finds the bytes already on the host
                pending.append((group, common.HostFetch(scores_dev)))
                del scores_dev
    with profiling.span("retrieval.fetch"):
        for group, fetch in pending:
            scores = fetch.numpy().astype(np.float32)
            for j, vidx in enumerate(group):
                rows.append((vidx, scores[j]))

    rows = sorted((r for part in dist.all_gather_objects(rows)
                   for r in part), key=lambda r: r[0])
    scored = [v for v, _ in rows]
    if scored != list(range(len(eval_ds))):
        raise RuntimeError(f"{len(eval_ds)} videos, but the processes "
                           f"scored {scored}: each must be scored once")
    score_matrix = np.stack([s for _, s in rows])      # (n_videos, n_caps)

    # captions are rows in the metric convention -> transpose
    vid_pos = {v: i for i, v in enumerate(eval_ds.video_ids)}
    gt_txt2vid = np.array([vid_pos[eval_ds.gt_cap_id2vid_id[i]]
                           for i in range(n_caps)])
    m = eval_metrics.retrieval_metrics(score_matrix.T, gt_txt2vid)
    flat = {f"t2v_{k}": v for k, v in m["text2video"].items()}
    flat.update({f"v2t_{k}": v for k, v in m["video2text"].items()})
    flat["score_matrix"] = score_matrix
    return flat


def start_inference(cfg: RunConfig) -> Dict:
    cfg = common.restore_inference_config(cfg)
    tokenizer = common.setup_tokenizer(cfg)
    cfg.num_labels = 2 if cfg.loss_type == "ce" else 1
    model_cfg = inject_task_attrs(common.load_model_config(cfg), cfg)
    compute_dtype = common.compute_dtype_for(cfg)
    model, step = common.load_inference_params(cfg, model_cfg, "retrieval")

    txt = cfg.inference_txt_db or cfg.val_datasets[0].txt_paths()[0]
    img = cfg.inference_img_db or cfg.val_datasets[0].img
    raw = load_jsonl(txt)
    for i, d in enumerate(raw):
        d["id"] = i
    ds = VideoRetrievalEvalDataset(
        raw, tokenizer, common.setup_store(img), fps=cfg.fps,
        num_frm=cfg.num_frm, max_img_size=cfg.max_img_size,
        max_txt_len=cfg.max_txt_len, ensemble_n_clips=cfg.inference_n_clips,
        device_preprocess=cfg.device_preprocess)
    m = inference_retrieval(cfg, model_cfg, model, ds, compute_dtype)
    if dist.is_main_process() and cfg.output_dir:
        out = {k: v for k, v in m.items() if k != "score_matrix"}
        save_json(out, os.path.join(
            cfg.output_dir, f"retrieval_metrics_step{step}.json"))
        LOGGER.info(out)
    return m


def main(argv=None) -> Dict:
    cfg = load_run_config(argv)
    # join the launch's process group before the device is first touched
    maybe_init_distributed(cfg)
    if cfg.do_inference:
        return start_inference(cfg)
    return start_training(cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
