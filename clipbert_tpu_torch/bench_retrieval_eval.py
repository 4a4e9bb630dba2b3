"""MSRVTT-scale retrieval eval wall on one card (port of
scripts/bench_retrieval_eval.py).

    python -m clipbert_tpu_torch.bench_retrieval_eval [--n_videos 64]
        [--n_captions 1000] [--n_clips 16] [--quantize 0|1]
        [--device cuda] [--deadline_s S]

Times the port's ``inference_retrieval`` (tasks/run_video_retrieval.py:
collate -> device resize / pad / normalize -> the CNN encode once per
video -> the full caption matrix scored with clip-LSE pooling) at the
MSRVTT protocol shape: every caption scored against every video, 16 clips
x 2 frames at 448^2, BERT-base + R50 with random weights from a seed,
bf16, BN folded, and with ``--quantize 1`` the transformer's denses in
int8 (models/clipbert.py::quantize_scoring_params). Decode is stubbed
with native-size (240x320) seeded frames, as in the JAX script; the data
plane is bench_dataplane's. Everything else is the production path.

The BERT side dominates: n_videos x n_captions x n_clips joint forwards,
independent across videos, so a slice of videos gives the per-video rate
and the 1000-video wall is that rate x 1000. ``sec_per_video_vs_1000_caps``
scales the per-video wall to 1000 captions where ``--n_captions`` is not
1000. Prints one JSON line with the stage stats and the kernel launches
of the timed run; a failure or the deadline prints ``value: null``
(utils/tool_run.py).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from clipbert_tpu_torch.utils.tool_run import (ToolRun, card, device_of,
                                               launch_counts, launches_since)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "msrvtt_retrieval_full_matrix_eval"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="print value null and exit 124 after this many "
                         "seconds (0: no deadline)")
    ap.add_argument("--n_videos", type=int, default=64)
    ap.add_argument("--n_captions", type=int, default=1000)
    ap.add_argument("--n_clips", type=int, default=16)
    ap.add_argument("--num_frm", type=int, default=2)
    ap.add_argument("--max_img_size", type=int, default=448)
    ap.add_argument("--video_batch", type=int, default=8)
    ap.add_argument("--caption_batch", type=int, default=64)
    ap.add_argument("--quantize", type=int, default=0,
                    help="int8-quantize the transformer's denses "
                         "(serve.py --quantize)")
    ap.add_argument("--model_config",
                    default=os.path.join(ROOT, "configs", "base_model.json"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    with ToolRun(METRIC, args.deadline_s) as run:
        from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
        from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
        from clipbert_tpu_torch.data.tokenization import (BertTokenizer,
                                                          write_tiny_vocab)
        from clipbert_tpu_torch.models import clipbert
        from clipbert_tpu_torch.tasks.run_video_retrieval import \
            inference_retrieval
        device = device_of(args.device)
        with tempfile.TemporaryDirectory(prefix="retr_eval_") as td:
            vpath = os.path.join(td, "vocab.txt")
            write_tiny_vocab(vpath, extra_tokens=["caption", "number"]
                             + [str(i) for i in range(10)])
            tok = BertTokenizer(vpath)
        datalist = [{"id": i, "txt": f"caption number {i % 97}",
                     "vid_id": f"v{i % args.n_videos}"}
                    for i in range(args.n_captions)]
        frames = np.random.default_rng(0).integers(
            0, 256, (args.n_clips * args.num_frm, 240, 320, 3),
            dtype=np.uint8)

        class StubDecodeDataset(VideoRetrievalEvalDataset):
            """The production dataset with decode stubbed; the device
            resize path stays live."""

            def load_video_multi_clips(self, vid_id, n_clips, random_clips,
                                       prev_clip_fallback=False, rng=None):
                return frames

        def dataset(rows):
            return StubDecodeDataset(
                rows, tok, media_store=None, fps=1, num_frm=args.num_frm,
                max_img_size=args.max_img_size, max_txt_len=20,
                ensemble_n_clips=args.n_clips, device_preprocess=True)

        cfg = RunConfig(model_config="", loss_type="ce", num_labels=2,
                        inference_n_clips=args.n_clips, num_frm=args.num_frm,
                        max_img_size=args.max_img_size, max_txt_len=20,
                        score_agg_func="lse",
                        inference_batch_size=args.caption_batch,
                        inference_video_batch_size=args.video_batch,
                        n_workers=2, fps=1, device=device.type)
        model_cfg = ModelConfig.from_json(args.model_config).replace(
            num_labels=2, loss_type="ce", score_agg_func="lse")
        run.at("model")
        model = clipbert.init_clipbert(
            model_cfg, "retrieval",
            generator=torch.Generator(device=device).manual_seed(0),
            device=device)
        model.eval().requires_grad_(False)
        clipbert.fold_cnn_bn_scales(model)
        if args.quantize:
            clipbert.quantize_scoring_params(model)

        run.at("warm (2 videos)")
        per = max(1, args.n_captions // args.n_videos)
        inference_retrieval(cfg, model_cfg, model, dataset(
            datalist[:2 * per]), torch.bfloat16)
        run.at(f"{args.n_videos} videos x {args.n_captions} captions")
        ds = dataset(datalist)
        stats = {}
        before = launch_counts()
        t0 = time.perf_counter()
        out = inference_retrieval(cfg, model_cfg, model, ds, torch.bfloat16,
                                  stats)
        dt = time.perf_counter() - t0
        launches = launches_since(before)
        if not np.isfinite(out["score_matrix"]).all():
            raise RuntimeError("non-finite scores")
        per_video = dt / args.n_videos
        per_video_1000 = per_video * 1000 / args.n_captions
        record = {
            "metric": METRIC, "value": per_video_1000,
            "unit": "s a video vs 1000 captions",
            "quantize": bool(args.quantize),
            "n_videos": args.n_videos, "n_captions": args.n_captions,
            "n_clips": args.n_clips, "seconds": dt,
            "sec_per_video_vs_1000_caps": per_video_1000,
            "full_1000x1000_seconds_est": per_video_1000 * 1000,
            "pair_clip_scores_per_sec":
                args.n_videos * args.n_captions * args.n_clips / dt,
            "stage_stats": {k: v for k, v in stats.items()
                            if isinstance(v, (int, float))},
            "launches": launches, "card": card(device)}
        run.emit(record)
    return record


if __name__ == "__main__":
    main()
