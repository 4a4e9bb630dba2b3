"""Driver: retrieval training through the port's ``train/steps.py::
make_train_step`` with the group-fused AdamW of ``train/optim.py``.

Set-up builds the one train step with its model (from the seeded
weights, through the port's checkpoint import) and optimizer state, and
drives it through its first ``check_steps`` steps on batches that all
differ; the window goes on with the same object and the same feed: a
cycle of ``feed_batches`` seeded batches on the device, each the
configuration's ``train_batch_size`` videos of ``train_n_clips`` clips of
preprocessed frames and 1 + ``itm_neg_size`` captions a video.
``train_samples_per_s`` is every video trained over all of the window's
time, the update included.

The check: the float32 reference (``benchmark/reference/``) takes the
same weights and the same first batches through the same number of
steps; each leaf's gradient norm at the first step as the optimizer took
it (its first moment over 1 - beta1) and each leaf's change after the
steps are set against the reference's, leaf by leaf, against the
reference's norm of that leaf or of the median leaf, and the median
leaf's gaps are compared (``compare``). Leaves whose
reference gradient is under a thousandth of the median leaf's move by
weight decay and round-off alone and are left out of the change."""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark import model_flops, weights
from benchmark.drivers import _common as C
from benchmark.reference import clipbert_ref as ref

STREAM_TEXT, STREAM_PIXELS, STREAM_STEP = 1, 2, 3
MOVED_FLOOR = 1e-3


class State:
    pass


def ref_name(port_name: str) -> str:
    """A port parameter's name in the published e2e checkpoint."""
    n = port_name.replace("cnn.resnet.", ref.CNN)
    n = n.replace("stem.conv.weight", "stem.conv1.weight")
    n = n.replace("cnn.grid_encoder.conv.weight", "cnn.grid_encoder.0.weight")
    n = n.replace(".layers.", ".layer.").replace(".ln.", ".LayerNorm.")
    n = n.replace("classifier.fc1.", "classifier.0.")
    return n.replace("classifier.fc2.", "classifier.2.")


def make_batch(cfg: Dict, tr: Dict, seed: int, i: int,
               device: torch.device, dtype) -> Dict[str, torch.Tensor]:
    """Batch ``i`` of the feed: normalized pixels in the compute dtype,
    (videos, clips * frames, S, S, 3); captions 1 + negatives a video,
    labels positive first."""
    Bv = cfg["train_batch_size"]
    group = 1 + cfg["itm_neg_size"]
    S = cfg["max_img_size"]
    nf = cfg["train_n_clips"] * cfg["num_frm"]
    gen = torch.Generator(device=device).manual_seed(
        int(C.rng(seed, STREAM_PIXELS, i).integers(1 << 62)))
    px = torch.randint(0, 256, (Bv, nf, S, S, 3), generator=gen,
                       device=device, dtype=torch.uint8).float()
    mean = torch.tensor(cfg["img_pixel_mean"], device=device)
    std = torch.tensor(cfg["img_pixel_std"], device=device)
    px = ((px - mean) / std).to(dtype)
    caps = C.texts(C.rng(seed, STREAM_TEXT, i), Bv * group,
                   tr["caption_words"], cfg["vocab_size"])
    ids, mask = C.as_ids(caps, cfg["max_txt_len"])
    labels = np.tile([1] + [0] * (group - 1), Bv)
    return {"visual_inputs": px,
            "text_input_ids": torch.from_numpy(ids).to(device),
            "text_input_mask": torch.from_numpy(mask).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def _schedule(cfg: Dict) -> Dict:
    a = cfg["assumed"]
    return {"total": a["num_train_steps"], "warmup": a["warmup_ratio"]}


def setup(ctx) -> State:
    from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
    from clipbert_tpu_torch.train import optim, steps, trainer
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.cfg, st.seed = cfg, ctx.seed
    st.dtype = torch.bfloat16 if cfg["bf16"] else torch.float32
    n_out = ref.num_outputs(cfg, "retrieval")
    sched = _schedule(cfg)
    model_cfg, run_cfg = C.port_configs(cfg, n_out,
                                        warmup_ratio=sched["warmup"],
                                        device=ctx.device.type)
    st.feed = [make_batch(cfg, tr, ctx.seed, i, ctx.device, st.dtype)
               for i in range(tr["feed_batches"])]
    st.check_steps = tr["check_steps"]
    if ctx.mode == "control":
        st.step = None
        return st
    w = weights.make_weights(cfg, "retrieval", ctx.seed, ctx.device)
    model = weights.load_into_port(w, model_cfg, "retrieval",
                                   cfg["img_input_format"] == "BGR",
                                   ctx.device)
    del w
    oc = trainer.optim_config_from_run(run_cfg)
    ss = trainer.schedule_from_run(run_cfg, sched["total"], 0)
    meta = optim.build_group_meta(model, oc)
    st.state = steps.init_train_state(model, meta)
    st.step = steps.make_train_step(model_cfg, rvr.make_task_settings(run_cfg),
                                    oc, ss, meta, compute_dtype=st.dtype)
    st.beta1 = oc.betas[0]
    params = {n: p for n, p in model.named_parameters() if meta[n].trainable}
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    st.losses, st.n_steps = [], 0
    for i in range(st.check_steps):
        _, m = st.step(st.state, st.feed[i % len(st.feed)],
                       _step_seed(st, i))
        st.losses.append(float(m["loss"]))
        if i == 0:
            st.grad_norms = {ref_name(n): float(st.state.opt.mu[n].norm())
                             / (1.0 - st.beta1) for n in params}
    st.n_steps = st.check_steps
    st.changes = {ref_name(n): float((p.detach() - p0[n].to(p.device))
                                     .norm()) for n, p in params.items()}
    return st


def _step_seed(st: State, i: int) -> int:
    return int(C.rng(st.seed, STREAM_STEP, i).integers(1 << 31))


def window(st: State, ctx) -> Dict:
    cfg = st.cfg
    Bv = cfg["train_batch_size"]
    if st.step is None:                    # control: no program to time
        return {"e2e": {"train_samples_per_s": float("nan")}, "work": {},
                "stats": {}, "attempted": 0, "failed": 0}
    pending = None
    n0 = st.n_steps
    t0 = time.perf_counter()
    while True:
        i = st.n_steps
        _, m = st.step(st.state, st.feed[i % len(st.feed)],
                       _step_seed(st, i))
        st.n_steps += 1
        if pending is not None:            # read one step late, as the
            float(pending["loss"])         # trainer does
        pending = m
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    last = float(pending["loss"])
    elapsed = time.perf_counter() - t0
    n = st.n_steps - n0
    samples = n * Bv
    S = cfg["max_img_size"]
    frames = cfg["train_n_clips"] * cfg["num_frm"]
    group = 1 + cfg["itm_neg_size"]
    fwd = (frames * model_flops.cnn_flops(S, S, cfg["hidden_size"],
                                          cfg["backbone_channel_in_size"])
           + group * cfg["train_n_clips"] * model_flops.bert_seq_flops(
               cfg, model_flops.joint_len(cfg),
               ref.num_outputs(cfg, "retrieval")))
    per_sample = model_flops.train_flops(
        fwd, frames * model_flops.stem_flops(S, S))
    return {"e2e": {"train_samples_per_s": samples / elapsed},
            "work": {"model_flops": per_sample * samples, "steps": n,
                     "samples": samples},
            "stats": {"last_loss": last},
            "attempted": samples, "failed": 0 if np.isfinite(last) else 1}


def release(st: State) -> None:
    for key in ("state", "step"):
        if hasattr(st, key):
            delattr(st, key)
    st.feed = None


def reference_steps(cfg: Dict, tr: Dict, seed: int, device,
                    prec: ref.Precision, dtype) -> Dict:
    """The reference's first ``check_steps`` steps on the feed's batches:
    {"losses", "grad_norms" (step 1, clipped), "changes"} by leaf."""
    from benchmark.reference.clipbert_ref import AdamW, linear_lr
    ref.strict_fp32()
    w = weights.make_weights(cfg, "retrieval", seed, device)
    params = {n: t.requires_grad_(True) for n, t in w.items()
              if ref.trainable(n)}
    W = dict(w)
    p0 = {n: t.detach().clone() for n, t in params.items()}
    opt = AdamW(params, tuple(cfg["betas"]), 1e-6, cfg["weight_decay"],
                cfg["cnn_weight_decay"], cfg["grad_norm"])
    sched = _schedule(cfg)
    group = 1 + cfg["itm_neg_size"]
    nc = cfg["train_n_clips"]
    chunk = tr["ref_chunk_videos"]
    out: Dict = {"losses": []}
    for i in range(tr["check_steps"]):
        b = make_batch(cfg, tr, seed, i % tr["feed_batches"], device, dtype)
        Bv = b["visual_inputs"].shape[0]
        Bt = Bv * group
        total = 0.0
        for n, p in params.items():
            p.grad = None
        for s in ref.chunks(Bv, chunk):
            t = slice(s.start * group, s.stop * group)
            with torch.enable_grad():
                loss = ref.retrieval_train_loss_sum(
                    W, cfg, b["visual_inputs"][s].float(),
                    b["text_input_ids"][t], b["text_input_mask"][t],
                    b["labels"][t], nc, group, prec) / Bt
                loss.backward()
            total += float(loss.detach())
        out["losses"].append(total)
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        lrs = [linear_lr(i + 1, cfg[key], sched["total"], sched["warmup"])
               for key in ("learning_rate", "cnn_learning_rate")]
        clipped = opt.step(grads, *lrs)
        if i == 0:
            out["grad_norms"] = {n: float(g.norm())
                                 for n, g in clipped.items()}
        del b
    out["changes"] = {n: float((p.detach() - p0[n]).norm())
                      for n, p in params.items()}
    return out


def compare(prog: Dict, want: Dict) -> Dict[str, float]:
    """The numbers compared: the median leaf's gradient-norm gap at the
    first step and the median moved leaf's change gap. The worst leaf's
    gaps and the steps' losses are printed, not compared: the worst leaf
    is an early convolution whose bf16 backward swings from seed to seed
    (ReLU masks flip), and the losses' gap reads alike for the program,
    the control and the planted faults (PERF.md)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], want["losses"]))
    grad_worst, g_leaf = ref.worst_leaf_gap(prog["grad_norms"],
                                            want["grad_norms"])
    gn = sorted(want["grad_norms"].values())
    med = gn[len(gn) // 2]
    moved = [n for n, v in want["grad_norms"].items()
             if v >= MOVED_FLOOR * med]
    change_worst, c_leaf = ref.worst_leaf_gap(prog["changes"],
                                              want["changes"], moved)
    print(f"losses {prog['losses']} reference {want['losses']} (widest "
          f"relative gap {loss_gap!r}); worst gradient leaf {g_leaf} "
          f"{prog['grad_norms'][g_leaf]!r} against "
          f"{want['grad_norms'][g_leaf]!r}, gap {grad_worst!r} (median "
          f"leaf {med!r}); worst change leaf {c_leaf} "
          f"{prog['changes'][c_leaf]!r} against {want['changes'][c_leaf]!r}"
          f", gap {change_worst!r}; {len(moved)} of {len(gn)} leaves moved",
          file=sys.stderr)
    return {"grad_norm_gap_median": ref.median_leaf_gap(
                prog["grad_norms"], want["grad_norms"]),
            "change_gap_median": ref.median_leaf_gap(
                prog["changes"], want["changes"], moved)}


def check(st: State, ctx) -> Dict[str, float]:
    cfg, tr = ctx.config, ctx.traffic
    want = reference_steps(cfg, tr, ctx.seed, ctx.device, ref.FP32,
                           st.dtype)
    if ctx.mode == "control":
        prog = reference_steps(cfg, tr, ctx.seed, ctx.device,
                               ref.Precision("fp8"), st.dtype)
    else:
        prog = {"losses": st.losses, "grad_norms": st.grad_norms,
                "changes": st.changes}
    return compare(prog, want)
