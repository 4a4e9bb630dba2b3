"""Train-step efficiency on one card: clips/s, TF/s, MFU and a component
split naming the top time sinks (port of scripts/bench_train_step.py).

    python -m clipbert_tpu_torch.bench_train_step [--sweep 4:0,8:early]
        [--components_batch 4] [--data_plane] [--device cuda]
        [--deadline_s S]

Measures the FULL train step (train/steps.py::make_train_step: MIL forward
over the clips, LSE loss, backward, the 8-group AdamW update, schedules)
at the MSRVTT retrieval train shape (configs/msrvtt_ret_base_resnet50.json:
8 clips x 2 frames at 448^2, 1 positive + 1 negative caption a video),
bf16, BERT-base + R50 with random weights from a seed. For each
``batch:remat`` of ``--sweep`` (the JAX script's sweep by default; remat 0
is off): the median step of ``--steps`` timed steps after ``--warmup``,
by CUDA events; FLOPs of one whole step from torch.utils.flop_counter.
FlopCounterMode (matmuls, convolutions and their backward; the
counterpart of XLA's cost analysis); TF/s and ``mfu`` against the H100
SXM's 989 TFLOP/s dense bf16; peak memory.

The component split (``--components_batch``, the JAX script's
bench_components): the CNN forward, the forward with its loss, forward +
backward and the whole step, each the median of its own timed calls, the
update found by subtraction; the group-fused and the per-leaf update
timed alone in turns on the step's gradients, with the device kernels
each launches; and the top device operations of one step from a
torch.profiler window (utils/profiling.py::TraceWindow).

``--data_plane`` (the JAX script's bench_train_data_plane): decode-
inclusive train clips/s through the port's loader (seeded videos in a
store -> decode in worker threads -> collate -> data/loader.py::
PrefetchLoader: pinned copy and device resize / pad / normalize one batch
ahead -> the step), beside the device-only rate of the same
configuration. ``--decoder`` picks the store's format (bench_dataplane).

One JSON line a configuration, one ``components`` line, one
``train_data_plane`` line; a failure or the deadline prints ``value:
null`` (utils/tool_run.py).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from clipbert_tpu_torch.utils.tool_run import (ToolRun, card, device_of,
                                               synchronize, timed_ms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_TFS = 989.0        # H100 SXM dense bf16 tensor-core peak, TFLOP/s
GROUP = 2               # captions a video: 1 positive + 1 negative
SWEEP = "4:0,8:stage,8:early,8:0,16:early,16:0"
METRIC = "train_step"
TOP_OPS = 12            # device operations of a step in the components line


def _remat(text: str):
    return {"0": False, "1": True}.get(text, text)


def task_settings(n_clips: int, remat=False):
    from clipbert_tpu_torch.train import steps
    return steps.TaskSettings(
        head_type="retrieval", num_labels=2, loss_type="ce",
        score_agg_func="lse", train_n_clips=n_clips, group_size=GROUP,
        remat=remat)


def make_batch(rng, cfg, args, batch_videos: int, device) -> Dict:
    """bv videos x n_clips x num_frm bf16 frames (the preprocessed pixels a
    step sees) and GROUP captions a video."""
    bt = batch_videos * GROUP
    return {
        "text_input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (bt, args.txt_len))).to(device),
        "text_input_mask": torch.ones(bt, args.txt_len, dtype=torch.int64,
                                      device=device),
        "visual_inputs": (torch.from_numpy(rng.standard_normal(
            (batch_videos, args.n_clips * args.num_frm, args.img, args.img,
             3), np.float32)) * 0.5).to(device, torch.bfloat16),
        "labels": torch.from_numpy(np.tile([1, 0], batch_videos)).to(device)}


class World:
    """The model, optimizer metadata, schedules and the step at one
    configuration."""

    def __init__(self, args, device, ts, seed: int = 0):
        from clipbert_tpu_torch.core.config import ModelConfig
        from clipbert_tpu_torch.models import clipbert
        from clipbert_tpu_torch.train import optim, steps
        self.cfg = ModelConfig.from_json(args.model_config).replace(
            num_labels=2, loss_type="ce", score_agg_func="lse")
        self.ts = ts
        self.oc = optim.OptimConfig()
        self.ss = steps.ScheduleSettings(num_train_steps=10000)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model = clipbert.init_clipbert(self.cfg, "retrieval",
                                            generator=gen, device=device)
        self.meta = optim.build_group_meta(self.model, self.oc)
        self.state = steps.init_train_state(self.model, self.meta)
        self.step = steps.make_train_step(self.cfg, ts, self.oc, self.ss,
                                          self.meta,
                                          compute_dtype=torch.bfloat16)


def _median_ms(fn, device, n: int) -> float:
    return float(np.median([timed_ms(fn, device) for _ in range(n)]))


def step_flops(world: World, batch) -> Optional[float]:
    """FLOPs of one whole step (forward, backward, update) by
    FlopCounterMode; the step runs (and updates the model) once."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        world.step(world.state, batch, 0)
    return float(counter.get_total_flops()) or None


def bench_step(args, device, batch_videos: int, remat) -> Dict:
    world = World(args, device, task_settings(args.n_clips, remat))
    batch = make_batch(np.random.default_rng(0), world.cfg, args,
                       batch_videos, device)
    flops = step_flops(world, batch)
    metrics = []

    def one():
        metrics.append(world.step(world.state, batch, len(metrics) + 1)[1])

    for _ in range(args.warmup):        # after the FLOP count's own step
        one()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms = _median_ms(one, device, args.steps)
    loss = float(metrics[-1]["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    clips = batch_videos * args.n_clips
    tfs = flops / (ms / 1e3) / 1e12 if flops else None
    out = {"metric": METRIC, "batch_videos": batch_videos,
           "remat": remat, "clips_per_sec": clips / (ms / 1e3),
           "step_ms": ms, "tf_per_sec": tfs,
           "mfu": tfs / PEAK_TFS if tfs else None,
           "peak_tf_per_sec": PEAK_TFS, "flops_per_step": flops,
           "flops_source": "flop_counter", "update": "fused",
           "loss": loss, "card": card(device)}
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del world, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def device_kernels(prof) -> List:
    """(name, device ms, launches) of every kernel a profiler window saw,
    by name; the CPU's own operators where no device ran."""
    from torch.autograd import DeviceType
    by: Dict[str, List[float]] = {}
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in events:
        rec = by.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us() / 1e3
        rec[1] += 1
    if not events:
        for e in prof.key_averages():
            by[e.key] = [e.self_cpu_time_total / 1e3, e.count]
    return sorted(((k, v[0], v[1]) for k, v in by.items()),
                  key=lambda r: -r[1])


def profiled(fn, device, trace_dir: Optional[str] = None):
    """fn() inside a TraceWindow of one step; returns the stopped profiler.
    Its Chrome trace goes to ``trace_dir``, else to a temporary directory
    that is removed on return."""
    from clipbert_tpu_torch.utils.profiling import TraceWindow
    with contextlib.ExitStack() as stack:
        if trace_dir is None:
            trace_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="train_trace_"))
        window = TraceWindow(trace_dir, start_step=0, num_steps=1)
        window.maybe_start(0)
        fn()
        synchronize(device)
        return window.maybe_stop(1)


def bench_components(args, device, batch_videos: int) -> Dict:
    """The step split into its parts, each timed alone (medians)."""
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.train import optim, steps
    world = World(args, device, task_settings(args.n_clips))
    batch = make_batch(np.random.default_rng(0), world.cfg, args,
                       batch_videos, device)
    model, n = world.model, args.steps
    params = dict(model.named_parameters())

    def cnn():
        with torch.no_grad():
            clipbert.cnn_forward(model.cnn, batch["visual_inputs"],
                                 torch.bfloat16, use_kernels=False)

    def fwd():
        with torch.no_grad():
            steps.compute_loss(model, world.cfg, world.ts, batch, 1, True,
                               torch.bfloat16)

    def fwd_bwd():
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, _ = steps.compute_loss(model, world.cfg, world.ts, batch, 1,
                                         True, torch.bfloat16)
            loss.backward()

    def full():
        world.step(world.state, batch, 1)

    out = {}
    for name, fn in (("cnn_fwd_ms", cnn), ("fwd_ms", fwd),
                     ("fwd_bwd_ms", fwd_bwd), ("full_step_ms", full)):
        fn()
        out[name] = _median_ms(fn, device, n)
    out["bert_fwd_ms"] = out["fwd_ms"] - out["cnn_fwd_ms"]
    out["bwd_ms"] = out["fwd_bwd_ms"] - out["fwd_ms"]
    out["update_by_subtraction_ms"] = out["full_step_ms"] - out["fwd_bwd_ms"]

    # the update alone, both forms in turns, on the last backward's grads
    fwd_bwd()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items() if world.meta[k].trainable}
    for p in params.values():
        p.grad = None
    forms = {"fused": optim.adamw_update,
             "per_leaf": optim.adamw_update_per_leaf}

    def update(form):
        form(params, grads, world.state.opt, world.meta, world.oc,
             np.float32(1e-5), np.float32(1e-5))

    upd = {}
    for form in forms.values():
        update(form)
    for key in ("fused", "per_leaf", "per_leaf", "fused"):
        upd.setdefault(key, []).append(_median_ms(
            functools.partial(update, forms[key]), device, n))
    for key, form in forms.items():
        out[f"update_{key}_ms"] = upd[key]
        kern = device_kernels(profiled(functools.partial(update, form),
                                       device))
        out[f"update_{key}_launches"] = sum(k[2] for k in kern)
        out[f"update_{key}_device_ms"] = sum(k[1] for k in kern)
    del grads

    kern = device_kernels(profiled(full, device, args.trace_dir))
    out["step_launches"] = sum(k[2] for k in kern)
    out["step_device_ms"] = sum(k[1] for k in kern)
    out["top_ops"] = [{"name": k[0][:120], "ms": k[1], "launches": k[2]}
                      for k in kern[:TOP_OPS]]
    out["batch_videos"] = batch_videos
    out["card"] = card(device)
    del world, batch, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def bench_data_plane(args, device, batch_videos: int, device_rate: float,
                     n_steps: int = 6) -> Dict:
    """Decode-inclusive train clips/s through the port's training loader
    (the trainer's input side) into the step, and the host-only decode
    rate; the host reads each step's loss one step late, as the trainer
    does."""
    from clipbert_tpu_torch import bench_dataplane
    from clipbert_tpu_torch.core.config import RunConfig
    from clipbert_tpu_torch.data import tokenization
    from clipbert_tpu_torch.data.datasets import (RetrievalCollator,
                                                  VideoRetrievalTrainDataset,
                                                  group_datalist_by_visual)
    from clipbert_tpu_torch.data.store import open_store
    from clipbert_tpu_torch.data.transforms import mk_input_group
    from clipbert_tpu_torch.tasks import common
    from clipbert_tpu_torch.train import trainer

    n_videos = batch_videos * (n_steps + 3)
    with tempfile.TemporaryDirectory(prefix="bench_train_plane_") as tmp:
        store_path = os.path.join(tmp, "videos.cbpk")
        decoder = bench_dataplane.make_store(store_path, n_videos,
                                             args.decoder)
        vpath = os.path.join(tmp, "vocab.txt")
        tokenization.write_tiny_vocab(
            vpath, extra_tokens=["a", "person", "does", "thing"]
            + [str(i) for i in range(10)])
        tok = tokenization.BertTokenizer(vpath)
        raw = [{"id": i, "txt": f"a person does thing {i % 10}",
                "vid_id": f"vid{i}"} for i in range(n_videos)]
        groups = mk_input_group(group_datalist_by_visual(raw, "vid_id"),
                                max_n_example_per_group=1, is_train=True)
        ds = VideoRetrievalTrainDataset(
            groups, tok, open_store(store_path), fps=1,
            num_frm=args.num_frm, frm_sampling_strategy="rand",
            max_img_size=args.img, max_txt_len=args.txt_len,
            itm_neg_size=GROUP - 1, ensemble_n_clips=args.n_clips,
            random_sample_clips=True, seed=0, device_preprocess=True)
        rcfg = RunConfig(train_batch_size=batch_videos, seed=0,
                         max_img_size=args.img, max_txt_len=args.txt_len,
                         n_workers=max(4, os.cpu_count() or 1),
                         device=device.type)
        loader, _ = common.build_train_loader(
            ds, RetrievalCollator(tok, args.txt_len), rcfg)
        it = iter(loader)
        mean, std = common.pixel_mean_std(rcfg)
        world = World(args, device, task_settings(args.n_clips, True))
        spec = trainer.TaskSpec(name="bench", head_type="retrieval",
                                settings=world.ts, train_loader=loader,
                                steps_per_epoch=1, mean=mean, std=std,
                                max_img_size=args.img)

        def step(seed):
            batch = trainer._to_device_batch(next(it), device, spec,
                                             torch.bfloat16)
            return world.step(world.state, batch, seed)[1]

        for i in range(2):                 # warm the threads and cuDNN
            m = step(i)
        float(m["loss"])
        t0 = time.perf_counter()
        pending = None
        for i in range(n_steps):
            m = step(100 + i)
            if pending is not None:
                float(pending["loss"])
            pending = m
        final = float(pending["loss"])
        wall = time.perf_counter() - t0
        if not np.isfinite(final):
            raise RuntimeError(f"non-finite loss {final}")
        t0 = time.perf_counter()
        for i in range(batch_videos):
            ds[i]
        decode_rate = batch_videos * args.n_clips / (time.perf_counter() - t0)
    e2e = n_steps * batch_videos * args.n_clips / wall
    return {"metric": "train_data_plane", "batch_videos": batch_videos,
            "remat": True, "decoder": decoder,
            "e2e_train_clips_per_sec": e2e,
            "device_train_clips_per_sec": device_rate,
            "overlap_efficiency": e2e / device_rate,
            "decode_clips_per_sec": decode_rate,
            "host_cores": os.cpu_count(), "card": card(device)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="print value null and exit 124 after this many "
                         "seconds (0: no deadline)")
    ap.add_argument("--model_config",
                    default=os.path.join(ROOT, "configs", "base_model.json"))
    ap.add_argument("--sweep", default=SWEEP,
                    help="comma-separated batch_videos:remat (remat 0, 1, "
                         "stage, early, block); empty for none")
    ap.add_argument("--components_batch", type=int, default=4,
                    help="batch of the component split (0: skip it)")
    ap.add_argument("--data_plane", action="store_true",
                    help="also the decode-inclusive train rate at 8 videos")
    ap.add_argument("--data_plane_batch", type=int, default=8)
    ap.add_argument("--decoder", default="native",
                    choices=("native", "jseq"))
    ap.add_argument("--n_clips", type=int, default=8)
    ap.add_argument("--num_frm", type=int, default=2)
    ap.add_argument("--img", type=int, default=448)
    ap.add_argument("--txt_len", type=int, default=20)
    ap.add_argument("--steps", type=int, default=8,
                    help="timed calls a measurement (the median)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--trace_dir", default=None,
                    help="where the step's Chrome trace goes (a temporary "
                         "directory by default)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    records = []
    with ToolRun(METRIC, args.deadline_s) as run:
        def emit(record):
            records.append(record)
            run.emit(record)

        device = device_of(args.device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        for item in filter(None, args.sweep.split(",")):
            bv, remat = item.split(":")
            run.at(f"step {bv} videos, remat {remat}")
            try:
                emit(bench_step(args, device, int(bv), _remat(remat)))
            except torch.cuda.OutOfMemoryError as e:
                # an OOM documents itself, as in the JAX sweep
                emit({"metric": METRIC, "batch_videos": int(bv),
                      "remat": _remat(remat), "value": None,
                      "error": type(e).__name__})
                torch.cuda.empty_cache()
        if args.components_batch:
            run.at(f"components at {args.components_batch} videos")
            emit({"metric": "train_step_components",
                  "components": bench_components(
                      args, device, args.components_batch)})
        if args.data_plane:
            # the device-only rate at the same configuration: the sweep's
            # where it ran it, else measured here
            dev = [r for r in records if r.get("clips_per_sec")
                   and r["batch_videos"] == args.data_plane_batch
                   and r["remat"] is True]
            if not dev:
                run.at("device-only rate for the data plane")
                dev = [bench_step(args, device, args.data_plane_batch, True)]
            run.at("train data plane")
            emit(bench_data_plane(args, device, args.data_plane_batch,
                                  dev[0]["clips_per_sec"]))
    return records


if __name__ == "__main__":
    main()
