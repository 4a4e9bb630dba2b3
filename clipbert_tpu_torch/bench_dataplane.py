"""Data-plane benchmark: decode -> device preprocess -> ResNet -> BERT, end
to end on video bytes (port of scripts/bench_dataplane.py).

    python -m clipbert_tpu_torch.bench_dataplane [--n_videos 24]
        [--decoder native|jseq] [--device_rate R] [--device cuda]
        [--deadline_s S]

Writes MSRVTT-shaped 320x240 videos into a store and runs the 16-clip
MSRVTT retrieval inference unit through the port's pipeline:
VideoRetrievalEvalDataset (decode, the 16-clip ensemble) -> threaded
loader with pinned copies -> device resize / pad / normalize -> the CNN
encode once per video -> caption scoring (tasks/run_video_retrieval.py::
inference_retrieval), BERT-base + R50 at 448^2 with random weights from a
seed, bf16.

``--decoder`` picks the videos' format and so the decoder: ``native``
(H.264 mp4 from the native encoder, decoded by native/libclipbert_data.so,
built by ``make -C native`` if it is not there; an error where it does
not build) or ``jseq`` (JPEG sequences, decoded by PIL or cv2). The JSON
lines name the decoder that ran.

One JSON line each for three clips/s rates:
  host_decode  the loader alone (decode + ensemble, no device work);
  device_unit  the device-only rate of the same unit: ``mil_forward`` on
               8 videos x n_clips of seeded frames (chip_smoke.py's bench
               unit), measured here unless ``--device_rate`` gives it;
  end_to_end   the wall of the whole overlapped pipeline, with the kernel
               launches it made.
A failure or the deadline prints ``value: null`` (utils/tool_run.py).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from clipbert_tpu_torch.utils.tool_run import (ToolRun, card, device_of,
                                               launch_counts, launches_since,
                                               timed_ms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")
METRIC = "dataplane"
UNIT_VIDEOS = 8


def make_store(path: str, n_videos: int, decoder: str, w: int = 320,
               h: int = 240, frames: int = 120, fps: float = 12.0) -> str:
    """n_videos seeded videos of ``frames`` (+ 0, 8 or 16, so seeks
    differ) frames at w x h into a store at ``path``; returns the decoder
    that reads them."""
    from clipbert_tpu_torch.bench_serving import make_clip
    from clipbert_tpu_torch.data.store import PackWriter
    if decoder == "native":
        lib_path = os.path.join(NATIVE, "libclipbert_data.so")
        if not os.path.exists(lib_path):
            done = subprocess.run(["make", "-C", NATIVE], capture_output=True,
                                  text=True)
            if done.returncode != 0:
                raise RuntimeError(
                    "native decoder: make -C native failed (pass --decoder "
                    "jseq for JPEG-sequence videos):\n"
                    + done.stderr[-2000:])
        lib = ctypes.CDLL(lib_path)
        lib.venc_make_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double]
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td, PackWriter(path) as wtr:
        for i in range(n_videos):
            n = frames + (i % 3) * 8
            if decoder == "native":
                mp4 = os.path.join(td, f"v{i}.mp4")
                if lib.venc_make_test_video(mp4.encode(), w, h, n, fps):
                    raise RuntimeError(f"native encoder failed on video {i}")
                with open(mp4, "rb") as f:
                    wtr.put(f"vid{i}", f.read())
            else:
                wtr.put(f"vid{i}", make_clip(rng, frames=n, h=h, w=w,
                                             fps=fps))
    return decoder


def unit_rate(model, cfg, args, device, n: int = 3) -> float:
    """Device-only clips/s of mil_forward on UNIT_VIDEOS videos x n_clips
    x num_frm seeded bf16 frames (the CNN's kernel form, the einsum core,
    as bench.py's unit), the median of ``n`` timed calls after one warm."""
    from clipbert_tpu_torch.train import steps
    rng = np.random.default_rng(1)
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse", train_n_clips=args.n_clips)
    batch = {
        "text_input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (UNIT_VIDEOS, 20))).to(device),
        "text_input_mask": torch.ones(UNIT_VIDEOS, 20, dtype=torch.int64,
                                      device=device),
        "visual_inputs": (torch.from_numpy(rng.standard_normal(
            (UNIT_VIDEOS, args.n_clips * args.num_frm, args.max_img_size,
             args.max_img_size, 3), np.float32)) * 0.5).to(
            device, torch.bfloat16)}

    def call():
        steps.mil_forward(model, cfg, ts, batch, torch.bfloat16)

    call()
    ms = float(np.median([timed_ms(call, device) for _ in range(n)]))
    return UNIT_VIDEOS * args.n_clips / (ms / 1e3)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="print value null and exit 124 after this many "
                         "seconds (0: no deadline)")
    ap.add_argument("--decoder", default="native",
                    choices=("native", "jseq"))
    ap.add_argument("--n_videos", type=int, default=24)
    ap.add_argument("--n_clips", type=int, default=16)
    ap.add_argument("--num_frm", type=int, default=2)
    ap.add_argument("--max_img_size", type=int, default=448)
    ap.add_argument("--frames", type=int, default=120,
                    help="frames a video (12 fps, 320x240)")
    ap.add_argument("--device_rate", type=float, default=None,
                    help="the device-only clips/s to report instead of "
                         "measuring the unit")
    ap.add_argument("--model_config",
                    default=os.path.join(ROOT, "configs", "base_model.json"))
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    with ToolRun(METRIC, args.deadline_s) as run:
        from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
        from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
        from clipbert_tpu_torch.data.store import open_store
        from clipbert_tpu_torch.data.tokenization import (BertTokenizer,
                                                          write_tiny_vocab)
        from clipbert_tpu_torch.models import clipbert
        from clipbert_tpu_torch.tasks.run_video_retrieval import \
            inference_retrieval
        device = device_of(args.device)
        with tempfile.TemporaryDirectory(prefix="dataplane_") as tmp:
            run.at(f"store of {args.n_videos} {args.decoder} videos")
            store_path = os.path.join(tmp, "videos.cbpk")
            t0 = time.perf_counter()
            decoder = make_store(store_path, args.n_videos, args.decoder,
                                 frames=args.frames)
            store_s = time.perf_counter() - t0
            vpath = os.path.join(tmp, "vocab.txt")
            write_tiny_vocab(vpath, extra_tokens=[
                "a", "person", "does", "thing", "number"]
                + [str(i) for i in range(10)])
            tok = BertTokenizer(vpath)
            datalist = [{"id": i, "txt": f"a person does thing number "
                         f"{i % 10}", "vid_id": f"vid{i % args.n_videos}"}
                        for i in range(args.n_videos)]

            def dataset(rows):
                return VideoRetrievalEvalDataset(
                    rows, tok, open_store(store_path), fps=1,
                    num_frm=args.num_frm, max_img_size=args.max_img_size,
                    max_txt_len=20, ensemble_n_clips=args.n_clips,
                    device_preprocess=True)

            ds = dataset(datalist)
            run.at("host decode")
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds[i]
            host_rate = args.n_videos * args.n_clips / (
                time.perf_counter() - t0)
            if ds.n_fallbacks:
                raise RuntimeError(f"{ds.n_fallbacks} videos did not decode")

            cfg = RunConfig(model_config="", loss_type="ce", num_labels=2,
                            inference_n_clips=args.n_clips,
                            num_frm=args.num_frm,
                            max_img_size=args.max_img_size, max_txt_len=20,
                            score_agg_func="lse", inference_batch_size=64,
                            inference_video_batch_size=4,
                            n_workers=4, fps=1,
                            device=device.type)
            model_cfg = ModelConfig.from_json(args.model_config).replace(
                num_labels=2, loss_type="ce", score_agg_func="lse")
            run.at("model")
            model = clipbert.init_clipbert(
                model_cfg, "retrieval",
                generator=torch.Generator(device=device).manual_seed(0),
                device=device)
            clipbert.fold_cnn_bn_scales(model.eval().requires_grad_(False))
            device_rate = args.device_rate
            if device_rate is None:
                run.at("device unit")
                device_rate = unit_rate(model, model_cfg, args, device)
            run.at("warm end to end (2 videos)")
            inference_retrieval(cfg, model_cfg, model, dataset(datalist[:2]),
                                torch.bfloat16)
            run.at("end to end")
            stats = {}
            before = launch_counts()
            t0 = time.perf_counter()
            out = inference_retrieval(cfg, model_cfg, model, ds,
                                      torch.bfloat16, stats)
            e2e_s = time.perf_counter() - t0
            launches = launches_since(before)
            if not np.isfinite(out["score_matrix"]).all():
                raise RuntimeError("non-finite scores")
        e2e_rate = args.n_videos * args.n_clips / e2e_s
        common = {"unit": "clips/s", "decoder": decoder,
                  "host_cores": os.cpu_count(), "card": card(device)}
        records = [
            {"metric": "dataplane_host_decode_clips_per_sec",
             "value": host_rate, "store_s": store_s, **common},
            {"metric": "dataplane_device_unit_clips_per_sec",
             "value": device_rate,
             "source": "given" if args.device_rate is not None
             else f"measured: mil_forward, {UNIT_VIDEOS} videos x "
                  f"{args.n_clips} clips", **common},
            {"metric": "dataplane_end_to_end_clips_per_sec",
             "value": e2e_rate, "seconds": e2e_s, "n_videos": args.n_videos,
             "stage_stats": {k: v for k, v in stats.items()
                             if isinstance(v, (int, float))},
             "launches": launches, **common}]
        for record in records:
            run.emit(record)
    return records


if __name__ == "__main__":
    main()
