#!/usr/bin/env python3
"""Smoke test of the PyTorch port (clipbert_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
 1. device: requires CUDA; prints the card's name and power limit as
    nvidia-smi gives them; turns TF32 off for the fp32 comparisons.
 2. build: compiles the three csrc/*.cu libraries with nvcc, one process
    per source, all started together (timed), and prints each kernel's
    ptxas registers and spills; every instantiation of the attention
    kernel's tensor-core body, of matmul_bn_act's wgmma body and of the
    stem's tensor-core body must spill nothing.
 3. kernel vs plain, fused attention: the kernel against its plain PyTorch
    version at the serving, eval, ragged, tensor-core edge and longest
    shapes, fp32 and bf16, contiguous operands, strided views of one merged
    QKV tensor and views whose rows miss 16-byte alignment, each case
    printing the body that ran (ops/fused_attention.py::_plan: the
    tensor-core body "tc" for bf16 with dh % 16 == 0 and S <= 128, else the
    fp32 CUDA-core body "v2") and checking the counters agree. At the
    serving and eval shapes, the tc body, the v2 body (forced, and held to
    the same bound), the plain version and SDPA are timed in turns, each as
    the replay of a CUDA graph of its calls (device time: at the small
    shapes a call's host work outlasts its device work).
 4. kernel vs plain, matmul_bn_act: every distinct 1x1 conv of ResNet-50 at
    32 frames of 448^2 plus ragged, tail and unaligned cases, fp32 and
    bf16, each case printing the body that ran (ops/matmul_bn_act.py::
    _plan: the wgmma body "wg" for bf16 operands TMA can describe, which is
    every R50 shape, else the mma.sync body "mma") and checking the
    counters agree; every wg tile width at a ragged and a strided case;
    the host time of a call on each body. At each of the 16 R50 shapes the
    wg body, the mma body (forced), the plain version and the library
    (addmm, or cuDNN's conv with its bias where the conv is strided, then
    the residual add and ReLU the shape has) are timed in turns as CUDA
    graph replays, then wg's three tile widths in turns; then the sums over
    one encode's 36 launches (launches x ms) and their bound.
 5. kernel vs plain, fused_stem_pool: 32 and 2 frames of 448^2 and small
    and odd sizes, fp32 (body direct), bf16 (the tensor-core body "tc",
    ops/fused_stem_pool.py::_plan) and bf16 on the direct body (forced),
    checking the counters agree; tc, direct, the plain version and cuDNN's
    conv + bias + ReLU + max_pool2d timed in turns as CUDA graph replays at
    32 and 2 frames.
 6. the serving slice at full width: RetrievalScorer on configs/
    base_model.json with random weights from a seeded generator, at 1 and
    16 clips, requests of 1, 5 and 32 captions on seeded uint8 240x320
    frames. Counts from 0: every scoring call must launch attention once
    per encoder layer, on the tensor-core body, every encode 36 fused 1x1
    convs, all on the wgmma body, and one fused stem, on its tensor-core
    body. Then the CNN's kernel form and cuDNN form in turns; their grid
    features on the same frames must agree within FEAT_REL, as must the
    kernel form's with matmul_bn_act's two bodies and with the stem's two
    bodies, and the kernel form with a planted wiring fault must not. Then
    one request through the plain attention path.
 7. the eval path at full width: tasks.run_video_retrieval.
    inference_retrieval with the configs/msrvtt_ret_base_resnet50.json
    settings (16 clips x 2 frames at 448^2, text length 20, bf16, folded
    BN) on a synthetic store of 16 seeded 240x320 JPEG-sequence videos and
    72 captions. Counts from 0: 36 + 1 CNN launches per encode, the 36
    on the wgmma body and the stem on its tensor-core body, 12 attention
    launches per prob dispatch, all on the tensor-core body.
    Then the same eval in the cuDNN form; the score matrices must agree
    within PROB_ATOL, and the first video group's grid features within
    FEAT_REL, as in phase 6.
 8. the bench unit (bench.py's mil_forward at 8 videos x 16 clips and 128
    videos x 1 clip), kernel form against cuDNN form in turns, clips/s.
10. tensor-parallel scoring at full width: fused_attention_shard_heads
    against its plain version at the head-shard shapes (6 and 3 local
    heads, strided views of a rank's merged QKV), timed as in phase 3
    beside the v2 body and SDPA; then 2 ranks on a (1 data x 2 model)
    mesh and 4 ranks on a (2 x 2) mesh, spawned on this one card over
    gloo, each Megatron-splitting the same seeded model and running
    make_text_prob_step(mesh=) on 1 video x 16 clips x 8 captions. Counts
    from 0 in every rank: exactly 12 kernel launches per call, all on the
    tensor-core body, at 6 local heads. Every rank's probabilities must
    agree with the single-process kernel path within PROB_ATOL and its
    final hidden states within TP_HIDDEN_REL, in bf16 and in fp32; one
    planted fault (one layer's row-parallel reduce dropped on one rank)
    must land at least 3x outside each bound.
11. multi-process eval: 2 processes on this card over gloo (phase 10's
    pair of ranks, once their scoring is done, which saves a spawn) run
    inference_retrieval on phase 7's store; every video is scored once,
    every fused 1x1 conv runs the wgmma body and every stem the tc body,
    the merged matrix is bit-identical to phase 7's (the same group and
    minibatch shapes), and its R@K is the merged matrix's.
12. the attention bodies end to end, in turns: the tensor-core body
    against the v2 body (forced for this measurement only) in the scoring
    call of a 1-clip and a 16-clip request with 32 captions (windows tc,
    v2, v2, tc, v2, tc, tc, v2), and in phase 7's eval (tc, v2, v2, tc);
    the tc eval's matrix must be bit-identical to phase 7's and the v2
    eval's within PROB_ATOL of it.
13. matmul_bn_act's bodies end to end, in turns: the wgmma body against
    the mma.sync body (forced for this measurement only) in the 16-clip
    encode (windows wg, mma, mma, wg, mma, wg, wg, mma), the bench unit at
    8 x 16 and 128 x 1 clips, and phase 7's eval (wg, mma, mma, wg); the
    wg eval's matrix must be bit-identical to phase 7's and the mma eval's
    within PROB_ATOL of it.
14. (run after phase 12) the stem's bodies end to end, in turns: the tc
    body against the direct body (forced for this measurement only) in the
    16-clip and the 1-clip encode (windows tc, direct, direct, tc, direct,
    tc, tc, direct; their grid features on the same frames within
    FEAT_REL) and the bench unit at 8 x 16 and 128 x 1 clips.
15. (run after phase 14) the QA family at full width, each config at its own
    resolution and text length, with seeded models: VQA's seq_cls over
    3129 answers (bce), a seq_cls over a seeded 1500-answer vocabulary for
    frameqa and msrvtt_qa, the multiple-choice head for action. First the
    kernels at the new shapes, each against its plain version and timed
    in turns as graph replays beside the library call and the bound:
    attention at S = 149-169 (the v2 body: past the tensor-core body's
    S <= 128) and at MSRVTT-MC's eval batch, the stem at 1 and 32 frames
    of 768^2, the 36 fused 1x1 convs of one 768^2 frame. Then the scorers:
    VQAScorer on one 480x640 JPEG at 768 px with 1, 5 and 32 questions of
    text 20; VideoQAScorer on frameqa and action (1 clip x 1 frame at 768
    px, text 25) and msrvtt_qa (8 clips x 2 frames at 448 px, text 100).
    Counts from 0: every request launches attention 12 times on the body
    _plan names, 36 fused 1x1 convs on wg and one stem on tc. The kernel
    form against the cuDNN + einsum form: probabilities within PROB_ATOL,
    grid features within FEAT_REL, and at 768 px phase 6's planted faults
    outside it. Then the runners' own eval loops on seeded stores
    (run_video_qa.build_validate for action and frameqa and
    run_msrvtt_mc.inference_mc at 16 clips on phase 7's videos,
    run_vqa.build_validate on 32 seeded JPEGs): make_eval_step's fused
    core against its einsum core in turns (k, e, e, k), then the cuDNN +
    einsum form, whose predictions must equal the kernel form's except
    where an item's top two lie within PROB_ATOL (counted and printed).
 9. the last two lines: the kernels' JSON record (each kernel's design, and
    the earlier body's time beside it as ``earlier_ms``: attention's v2,
    matmul_bn_act's mma, the stem's direct; phase 15's launches, errors
    and times at the QA shapes as ``qa_launches``, ``qa_max_abs_err`` and
    ``qa_shapes``; phase 16's launches as ``train_launches``), then
    {"ok": true, "device": {...}}.

The ranks of phases 10 and 11 share the one card, so their process group
runs over gloo, passed explicitly (NCCL refuses two ranks on one device):
each row-parallel all-reduce and gather goes through the host. A rank that
fails or outlives its phase's timeout fails the script.

16. (after phase 15) MSRVTT retrieval training. 16a: one train step on
    the card against the CPU in fp32 with TF32 off (hidden 128, 2 layers,
    the full ResNet-50 at 64^2): loss, grad norm and every gradient within
    TRAIN_LOSS_RTOL / TRAIN_BERT_REL / TRAIN_CNN_REL, no kernel launched;
    the bf16 product's backward against fp32 autograd. 16b: run_video_
    retrieval.start_training at the config's width and batch (16 videos x
    8 clips x 2 frames at 448^2, bf16, seeded init) on phase 7's store
    for TRAIN_STEPS steps, validating at the last through
    inference_retrieval on the card. Counts from 0: every train step
    launches no kernel, the validation 12 tc attention launches per
    caption minibatch and 36 wg + 1 tc stem per encode; its matrix within
    PROB_ATOL of the cuDNN + einsum form's on the trained weights; frozen
    BN bit-unchanged, every parameter that had a gradient moved; the deploy
    checkpoint and restore bundle written, and a second run resumes at the
    saved step bit-equal to the bundle. 16c: LEARN_STEPS steps on one
    repeated batch at LEARN_LR: the loss falls by LEARN_MARGIN; the step
    time (CUDA events), train clips/s, peak memory and validation wall.

Imports nothing of JAX. Needs one card, nvcc and a few minutes.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.core.config import (ModelConfig, inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.core.mesh import Mesh, make_mesh
from clipbert_tpu_torch.data import store, transforms, video
from clipbert_tpu_torch.data.datasets import (MSRVTTMCEvalDataset,
                                              RetrievalCollator,
                                              VideoQACollator,
                                              VideoRetrievalEvalDataset,
                                              VQADataset, load_jsonl)
from clipbert_tpu_torch.data.tokenization import BertTokenizer, write_tiny_vocab
from clipbert_tpu_torch.evaluation import metrics as eval_metrics
from clipbert_tpu_torch.models import bert, clipbert, resnet
from clipbert_tpu_torch.ops import _build
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.ops import fused_stem_pool as fsp
from clipbert_tpu_torch.ops import matmul_bn_act as mba
from clipbert_tpu_torch.ops.linear import mm_f32
from clipbert_tpu_torch.parallel import shard_model
from clipbert_tpu_torch.serve import (RetrievalScorer, VideoQAScorer,
                                      VQAScorer, _pow2_bucket)
from clipbert_tpu_torch.tasks import (common, run_msrvtt_mc, run_video_qa,
                                      run_vqa)
from clipbert_tpu_torch.tasks.run_video_retrieval import inference_retrieval
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils.distributed import spawn_ranks

ROOT = os.path.dirname(os.path.abspath(__file__))
LIBRARIES = ("fused_attention", "matmul_bn_act", "fused_stem_pool")
# the register-resident bodies, every instantiation of which must not spill:
# attention's tensor-core body, matmul_bn_act's wgmma body (one per BN) and
# the stem's tensor-core body
NO_SPILL = ("fused_attention_tc_kernel", "matmul_bn_act_wg_kernel",
            "fused_stem_pool_tc_kernel")
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (B, S, H, dh, what): B = captions x clips at serving, the eval scoring
# batch, the ragged cases of tests/test_pallas_kernels.py:105, the longest
# joint sequence the kernel takes in this repo's configs
SHAPES = [(32, 69, 12, 64, "serve 1 clip x 32 captions"),
          (512, 69, 12, 64, "serve 16 clips x 32 captions"),
          (8192, 69, 12, 64, "eval scoring batch"),
          (3, 11, 4, 8, "ragged"),
          (129, 7, 4, 8, "ragged"),
          (3, 1, 2, 16, "tensor-core edge: one key"),
          (5, 17, 3, 48, "tensor-core edge: 2 warps, 15 padded keys"),
          (2, 128, 2, 128, "tensor-core limit: S 128, dh 128"),
          (3, 129, 2, 64, "just past the tensor-core limit"),
          (2, 620, 12, 64, "longest sequence")]
TIMED = SHAPES[:3]
# fp32: both sides sum the same fp32 products in another order (one warp
# FMA chain vs cuBLAS tiles), so they agree to ~1e-6; 1e-5 is the CPU
# tests' bound (tests/test_pallas_kernels.py:112).
FP32_TOL = 1e-5
# bf16: both round P to bf16 and the output to bf16; an exp or sum that
# differs in its last fp32 bit can flip one bf16 rounding of P (2**-8
# relative) or of the output (|o| < 4, one ulp <= 2**-6)
BF16_ATOL = 2e-2
# end to end through 12 bf16 layers: the per-layer flips above propagate
# through LayerNorm into the two-way softmax; probabilities are in [0, 1]
PROB_ATOL = 2e-2
# The CNN kernels against their plain versions. fp32: both sum the same
# fp32 products in another order (tensor-core tiles or a tap loop vs
# cuBLAS / cuDNN), so |kernel - plain| <= CNN_FP32_REL * the sum of the
# products' magnitudes (|x| @ |w| * |scale| + |bias| [+ |residual|], pooled
# over the window for the stem). bf16: both round one fp32 value each, so
# they may differ by one bf16 ulp of the result (<= 2**-7 |plain|) on top.
CNN_FP32_REL = 1e-5
BF16_ULP = 2.0 ** -7
# The CNN's kernel form against its cuDNN form on the same pixels: grid
# features compared as ||kernel - cuDNN|| / ||cuDNN|| over the whole batch.
# The forms round bf16 at other points, about one ulp per layer through 53
# convs; a wiring fault moves the features by far more, and every run
# plants two in the kernel form (_planted) to show that this bound catches
# them where PROB_ATOL on random-weight probabilities does not. On an H100
# at 448^2 the forms differed by 9.7e-3 to 9.9e-3 and the faults by 0.36
# (a dropped residual) and 0.135 (H and W swapped), while moving no
# probability by more than 1.3e-2 (PERF.md); the bound sits 3x above the
# first and 4.5x below the smallest fault.
FEAT_REL = 3e-2
CAPTION_WORDS = ["a", "man", "woman", "is", "playing", "guitar", "cooking",
                 "in", "the", "kitchen", "dog", "runs", "on", "beach", "car",
                 "driving", "down", "road", "people", "dancing", "stage",
                 "cat", "sits", "near", "window", "child", "swimming"]
REQUEST_SIZES = (1, 5, 32)
REPEATS = 5
TP_REPEATS = 3           # timed calls per rank: each ~0.7-0.9 s over gloo
# R50 1x1 convs per encode: conv1 and conv3 of 16 bottlenecks + 4 shortcuts
MBA_PER_ENCODE = 2 * sum(n for n, _, _ in resnet.R50_STAGES) + 4
FRAMES = 32        # 16 clips x 2 frames: one 16-clip request's CNN batch
EVAL_VIDEOS, EVAL_CAPTIONS = 16, 72
# Phase 10: 1 video x 16 clips x 8 captions of 20 tokens (S = 20 + 49)
TP_CLIPS, TP_CAPTIONS, TXT_LEN = 16, 8, 20
# Tensor-parallel final hidden states against the single-process kernel
# path on the same inputs, as ||TP - single|| / ||single|| over a rank's
# sequences, in the main path's bf16 and in fp32. Both sides sum the same
# fp32 products in another order (two K/2 partial products and a reduce vs
# one product over K, cuBLAS tiles chosen for other widths). In fp32 that
# is all: 9.56e-7 on an H100. In bf16 it flips roundings that the 12
# layers carry to 1.06e-2, about as far as the bf16 states sit from the
# fp32 ones (printed beside). Dropping layer 5's attention-output reduce on
# one rank moved the states by 0.168 (bf16) and 0.167 (fp32) (PERF.md, PR
# 3). Each bound sits ~3x above the gap, the fault at least 3x above it.
TP_HIDDEN_REL = {torch.bfloat16: 3e-2, torch.float32: 3e-6}
DTYPES = (torch.bfloat16, torch.float32)
FAULT_LAYER = 5          # the layer whose reduce the planted fault drops
RANK_TIMEOUT_S = 300     # per spawned group of ranks


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke "
                         "test needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print("card (nvidia-smi name, power.limit):")
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; TF32 off for matmul and cuDNN "
          "(the fp32 comparisons need full fp32)")
    try:
        importlib.import_module("torch.utils.tensorboard")
        tb = "present: the trainer writes TensorBoard event files"
    except ImportError as e:
        tb = (f"missing ({e}): the trainer writes its scalars to "
              "log/scalars.jsonl (utils/logger.py::JsonlScalarWriter)")
    print(f"tensorboard: {tb}")


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled template kernel of csrc/, e.g.
    fused_attention_tc_kernel<5, 4> (Li5E is the int 5, Lb1E the bool
    true, 13__nv_bfloat16 and f the types)."""
    m = re.search(r"([a-z_]+_kernel)I(\w+?)EEv", mangled)
    if not m:
        m = re.search(r"\d([a-z_]+_kernel)E", mangled)      # no template
        return m.group(1) if m else mangled
    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"L[ib](\d+)E", r"\1,", args)
    if args.startswith("f"):
        args = "float," + args[1:]
    return f"{m.group(1)}<{args.rstrip(',').replace(',', ', ')}>"


def _ptxas_report(log: str):
    """{kernel: [registers, spill store bytes, spill load bytes]} from the
    report of nvcc -Xptxas -v, kernels named by _kernel_name."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            report[name] = [None, None, None]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            report[name][1:] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name][0] = int(m.group(1))
    return report


def phase_build() -> float:
    t0 = time.perf_counter()
    paths = _build.build_libraries(LIBRARIES)
    for kernel in (fa._kernel, mba._kernel, fsp._kernel):
        kernel()
    dt = time.perf_counter() - t0
    print(f"build: {len(paths)} libraries in {dt:.2f} s (one nvcc each, "
          "in parallel)")
    reports = {name: _ptxas_report(path.with_suffix(".log").read_text())
               for name, path in paths.items()}
    spilled = []
    for name, path in paths.items():
        print(f"  {os.path.relpath(path, ROOT)}")
        for kern, (regs, st, ld) in reports[name].items():
            print(f"    ptxas: {kern}: {regs} registers, spill stores {st} "
                  f"B, spill loads {ld} B")
            if any(body in kern for body in NO_SPILL) and (st or ld):
                spilled.append(kern)
    counts = {body: sum(body in k for r in reports.values() for k in r)
              for body in NO_SPILL}
    print(f"build: {counts[NO_SPILL[0]]} instantiations of the attention "
          f"kernel's tensor-core body, {counts[NO_SPILL[1]]} of "
          f"matmul_bn_act's wgmma body, {counts[NO_SPILL[2]]} of the stem's "
          f"tensor-core body, {len(spilled)} spilling")
    if spilled or counts[NO_SPILL[0]] == 0 or \
            counts[NO_SPILL[1]] != len(mba.WG_TILE_NS) or \
            counts[NO_SPILL[2]] != 1:
        raise AssertionError(f"instantiations {counts}; spilling: {spilled}")
    return dt


def _bound_ms(flops: float, nbytes: float):
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


LAYOUTS = ("contiguous", "merged-qkv views", "unaligned views")


def _inputs(B, S, H, dh, dtype, layout, gen):
    if layout == "merged-qkv views":
        # q, k, v as the three strided views of one merged QKV projection
        qkv = torch.randn(B, S, 3 * H * dh, device="cuda", generator=gen)
        q, k, v = (t.view(B, S, H, dh)
                   for t in qkv.to(dtype).split(H * dh, dim=-1))
    elif layout == "unaligned views":
        # rows off 16-byte boundaries: the kernel's scalar staging path
        q, k, v = (torch.randn(B, S, H, dh + 1, device="cuda",
                               generator=gen).to(dtype)[..., 1:]
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(B, S, H, dh, device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
    keep = torch.rand(B, S, device="cuda", generator=gen) > 0.3
    keep[:, 0] = True                  # about 30% of keys masked, never key 0
    bias = (1.0 - keep.float()) * -10000.0
    return q, k, v, bias


def _time_ms(fn, iters: int, graph: bool = False) -> float:
    """Milliseconds per call of ``iters`` calls back to back, by CUDA
    events. ``graph``: the calls are captured in one CUDA graph and
    replayed, so the time is the device's alone; without it a call whose
    device work is shorter than its host work times the host."""
    for _ in range(3):
        fn()
    run = fn
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run, iters_run = g.replay, 1
    else:
        iters_run = iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters_run):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(kern, plain, iters, library=None, earlier=None, graph=False):
    """{"kernel", "plain"[, "library"][, "earlier"]: [ms, ms]}: each timed
    twice in turns (plain, kernel[, earlier, earlier], kernel, plain[,
    library, library]); ``earlier`` is an earlier design of the kernel;
    ``graph`` as for _time_ms."""
    order = (["plain", "kernel"] + ["earlier"] * 2 * (earlier is not None)
             + ["kernel", "plain"] + ["library"] * 2 * (library is not None))
    fns = {"kernel": kern, "plain": plain, "library": library,
           "earlier": earlier}
    ms = {}
    for name in order:
        ms.setdefault(name, []).append(_time_ms(fns[name], iters, graph))
    return ms


def _timing(ms, bound):
    """A kernel record's timing keys from _in_turns' windows."""
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    return {"ms": mean["kernel"], "plain_ms": mean["plain"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": mean.get("library"),
            "earlier_ms": mean.get("earlier")}


def _windows(ms, name):
    return " / ".join(f"{t:.4f}" for t in ms[name])


def _attention_check(B, S, H, dh, what, dtype, layout, gen, body=None):
    """One case of the kernel against its plain version; returns the max
    abs error. The counters must show the body _plan chose (or ``body``)."""
    scale = 1.0 / dh ** 0.5
    q, k, v, bias = _inputs(B, S, H, dh, dtype, layout, gen)
    plan = fa._plan(B, S, H, dh, dtype, fa._aligned16(q, k, v), body)
    # plain first: the kernel's fresh output buffer can then never be a
    # stale copy of this comparison's reference
    ref = fa.fused_attention_reference(q, k, v, bias, scale)
    before = (fa.LAUNCHES, fa.TC_LAUNCHES)
    out = (fa.fused_attention(q, k, v, bias, scale) if body is None
           else fa._launch(q, k, v, bias, scale, body=body))
    torch.cuda.synchronize()
    ran = (fa.LAUNCHES - before[0], fa.TC_LAUNCHES - before[1])
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        ok = bool((diff <= FP32_TOL + FP32_TOL * ref.float().abs()).all())
    else:
        ok = err <= BF16_ATOL
    staging = ("16-byte" if plan.body == "v2" else "cp.async") \
        if plan.vec else "element-wise"
    print(f"kernel vs plain {(B, S, H, dh)} {what} {str(dtype)[6:]} "
          f"{layout}: body {plan.body} ({32 * plan.warps} threads, "
          f"{plan.smem_bytes} B shared, {staging} staging"
          f"{', forced' if body else ''}): max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if ran != (1, int(plan.body == "tc")):
        raise AssertionError(f"fused_attention at {(B, S, H, dh)} {dtype}: "
                             f"counters moved {ran}, plan {plan}")
    if not ok:
        raise AssertionError(f"fused_attention disagrees with its plain "
                             f"version at {(B, S, H, dh)} {dtype} {layout} "
                             f"(body {plan.body}): {err}")
    return err


def phase_attention(gen):
    bf16_err = 0.0
    for B, S, H, dh, what in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for layout in LAYOUTS:
                err = _attention_check(B, S, H, dh, what, dtype, layout, gen)
                if dtype == torch.bfloat16:
                    bf16_err = max(bf16_err, err)
    for B, S, H, dh, what in TIMED:
        # the earlier body, timed below beside the tensor-core body
        _attention_check(B, S, H, dh, what, torch.bfloat16,
                         "merged-qkv views", gen, body="v2")
    times = {}
    for B, S, H, dh, what in TIMED:
        times[(B, S, H, dh)] = _time_attention(B, S, H, dh, what, gen)
    torch.cuda.empty_cache()
    return bf16_err, times


def _time_attention(B, S, H, dh, what, gen):
    """The kernel on the body _plan names, the plain version and SDPA (and
    the v2 body forced as the earlier design, where the plan is tc) timed
    in turns as CUDA graph replays on bf16 merged-QKV views; returns the
    kernel record's timing keys."""
    q, k, v, bias = _inputs(B, S, H, dh, torch.bfloat16, "merged-qkv views",
                            gen)
    body = fa._plan(B, S, H, dh, torch.bfloat16, True).body
    scale = 1.0 / dh ** 0.5
    iters = 20 if B <= 512 else 5
    # SDPA with the same additive key mask, on (B, H, S, dh) views
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = bias[:, None, None, :].to(torch.bfloat16)
    ms = _in_turns(
        lambda: fa.fused_attention(q, k, v, bias, scale),
        lambda: fa.fused_attention_reference(q, k, v, bias, scale),
        iters,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, mask,
                                               scale=scale),
        (lambda: fa._launch(q, k, v, bias, scale, body="v2"))
        if body == "tc" else None, graph=True)
    nbytes = 4 * B * S * H * dh * 2 + B * S * 4
    bound = _bound_ms(4 * B * H * S * S * dh, nbytes)
    earlier = (f", v2 body {_windows(ms, 'earlier')} ms" if body == "tc"
               else "")
    print(f"time bf16 {(B, S, H, dh)} {what} (device time, CUDA "
          f"graph of {iters} calls): {body} body "
          f"{_windows(ms, 'kernel')} ms{earlier}, plain "
          f"{_windows(ms, 'plain')} ms, SDPA {_windows(ms, 'library')} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]})")
    return _timing(ms, bound)


def _r50_1x1_launches(frames: int, img: int):
    """{(B, H, W, K, N, residual, stride, relu): launches per encode} of
    ResNet-50's fused 1x1 convs (stride on the 1x1 reduce conv,
    stride_in_1x1) for ``frames`` frames of ``img``^2, in the order they
    first run: conv1 (ReLU), the shortcut (no ReLU) and conv3 (residual and
    ReLU) of each stage's first bottleneck, conv1 of the others."""
    launches, cin, hw = {}, 64, img // 4
    for si, (n, cmid, cout) in enumerate(resnet.R50_STAGES):
        s = 1 if si == 0 else 2
        out_hw = hw // s
        for h, K, N, res, stride, relu, count in (
                (hw, cin, cmid, False, s, True, 1),
                (hw, cin, cout, False, s, False, 1),
                (out_hw, cmid, cout, True, 1, True, n),
                (out_hw, cout, cmid, False, 1, True, n - 1)):
            key = (frames, h, h, K, N, res, stride, relu)
            launches[key] = launches.get(key, 0) + count
        cin, hw = cout, out_hw
    return {k: n for k, n in launches.items() if n}


def _check_close(name, out, ref, mag, dtype):
    diff = (out.float() - ref.float()).abs()
    bound = CNN_FP32_REL * mag
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.float().abs()
    err = diff.max().item()
    ok = bool((diff <= bound).all())
    print(f"kernel vs plain {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
          f"(worst share of bound "
          f"{(diff / bound.clamp_min(1e-30)).max().item():.3f}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with its "
                             f"plain version by {err}")
    return err


# matmul_bn_act's cases beyond the 16 R50 shapes, (B, H, W, K, N, residual,
# stride, relu, layout): R off the 128-row tile, K = 8, 72 (a ragged last
# stage) and 2048, N = 64, 96, 136 (a ragged last sub-tile) and 2048, a
# strided conv with a residual and 18 whole output rows a tile; then the
# shapes the wgmma body does not take, on the mma body: K not a multiple of
# 8, a stride that does not divide H, an input 2 bytes off 16-byte
# alignment.
MBA_CASES = [(1, 100, 1, 64, 96, True, 1, True, "contiguous"),
             (1, 3, 1, 8, 8, False, 1, True, "contiguous"),
             (3, 17, 19, 72, 64, True, 1, True, "contiguous"),
             (1, 37, 5, 2048, 2048, False, 1, False, "contiguous"),
             (2, 10, 14, 64, 136, True, 2, True, "contiguous"),
             (1, 16, 16, 12, 64, False, 1, True, "contiguous"),
             (1, 9, 9, 64, 64, False, 2, True, "contiguous"),
             (2, 8, 8, 64, 64, True, 1, True, "unaligned")]


def _mba_inputs(B, H, W, K, N, res, stride, dtype, gen, layout="contiguous"):
    if layout == "unaligned":        # a view one element into its storage
        x = torch.randn(B * H * W * K + 1, device="cuda", generator=gen
                        ).to(dtype)[1:].view(B, H, W, K)
    else:
        x = torch.randn(B, H, W, K, device="cuda", generator=gen).to(dtype)
    w = torch.randn(N, K, 1, 1, device="cuda", generator=gen) * K ** -0.5
    sc = torch.rand(N, device="cuda", generator=gen) + 0.5
    b = torch.randn(N, device="cuda", generator=gen)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    r = (torch.randn(B, Ho, Wo, N, device="cuda", generator=gen).to(dtype)
         if res else None)
    return x, w, sc, b, r


def _mba_check(B, H, W, K, N, res, stride, relu, dtype, gen,
               layout="contiguous", tile_n=None):
    """One case of the kernel against its plain version; returns (max abs
    error, body). The counters must show the body _plan chose; ``tile_n``
    forces a wg tile width."""
    x, w, sc, b, r = _mba_inputs(B, H, W, K, N, res, stride, dtype, gen,
                                 layout)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xs = x[:, ::stride, ::stride].reshape(-1, K)
    r2 = None if r is None else r.reshape(-1, N)
    w_nk = w.reshape(N, K)
    ref = mba.matmul_bn_act_reference(xs, w_nk.t(), sc, b, r2, relu)
    plan = mba._plan(B * Ho * Wo, K, N, stride, H, W, Wo, dtype,
                     mba._aligned16(x, r), mba._n_sms(0), tile_n=tile_n)
    before = (mba.LAUNCHES, mba.WG_LAUNCHES)
    if tile_n is None:
        out = mba.conv1x1_bn_act(x, w, sc, b, stride, r, relu)
    else:
        out = mba._launch(x, w_nk, sc, b, r, relu, (B, H, W), stride,
                          tile_n=tile_n)
    out = out.reshape(-1, N)
    torch.cuda.synchronize()
    ran = (mba.LAUNCHES - before[0], mba.WG_LAUNCHES - before[1])
    mag = (xs.float().abs() @ w_nk.to(dtype).float().abs().t()) * sc \
        + b.abs()
    if r2 is not None:
        mag = mag + r2.float().abs()
    what = (f"matmul_bn_act R={B * Ho * Wo} K={K} N={N} residual={res} "
            f"stride={stride} relu={relu} {layout}: body {plan.body}"
            + (f" BN {plan.tile_n}, {plan.stages} stages, {plan.smem_bytes} "
               f"B shared, {plan.grid} blocks"
               + (" (forced)" if tile_n else "")
               if plan.body == "wg" else ""))
    err = _check_close(what, out, ref, mag, dtype)
    if ran != (1, int(plan.body == "wg")):
        raise AssertionError(f"{what}: counters moved {ran}, plan {plan}")
    return err, plan.body


def _mba_library(x, w, b, r, relu, stride):
    """One PyTorch call for the conv (addmm on the pixels, or cuDNN's
    strided conv with its bias), then the residual add and ReLU the shape
    has: the yardstick, never called by the port."""
    N, K = w.shape[:2]
    b16 = b.to(x.dtype)
    if stride == 1:
        x2, w2 = x.reshape(-1, K), w.reshape(N, K).t()
        r2 = None if r is None else r.reshape(-1, N)

        def conv():
            return torch.addmm(b16, x2, w2)
    else:
        xc, r2 = x.permute(0, 3, 1, 2), None if r is None else \
            r.permute(0, 3, 1, 2)
        wc = w.contiguous(memory_format=torch.channels_last)

        def conv():
            return F.conv2d(xc, wc, b16, stride)

    def library():
        y = conv()
        if r2 is not None:
            y = y + r2
        return torch.relu(y) if relu else y
    return library


def phase_matmul_bn_act(gen):
    launches = _r50_1x1_launches(FRAMES, 448)
    if sum(launches.values()) != MBA_PER_ENCODE:
        raise AssertionError(f"{sum(launches.values())} 1x1 convs per "
                             f"encode, expected {MBA_PER_ENCODE}")
    bf16_err = 0.0
    cases = [s + ("contiguous",) for s in launches] + MBA_CASES
    for B, H, W, K, N, res, stride, relu, layout in cases:
        for dtype in (torch.float32, torch.bfloat16):
            err, body = _mba_check(B, H, W, K, N, res, stride, relu, dtype,
                                   gen, layout)
            if dtype == torch.bfloat16:
                bf16_err = max(bf16_err, err)
                if (B, H, W, K, N, res, stride, relu) in launches and \
                        body != "wg":
                    raise AssertionError(f"R50 shape {(H, K, N)} ran body "
                                         f"{body}, not wg")
    # every wg tile width at a ragged shape and a strided one
    for tile_n in mba.WG_TILE_NS:
        for case in ((3, 17, 19, 72, 136, True, 1, True),
                     (2, 10, 14, 64, 136, True, 2, False)):
            err, _ = _mba_check(*case, torch.bfloat16, gen, tile_n=tile_n)
            bf16_err = max(bf16_err, err)

    # host work per call: the wg body encodes its tensor maps on the host
    x, w, sc, b, r = _mba_inputs(2, 8, 8, 64, 64, True, 1, torch.bfloat16,
                                 gen)
    w_nk = w.reshape(64, 64).to(torch.bfloat16)
    host_us = {}
    for body in ("mma", "wg", "wg", "mma"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            mba._launch(x, w_nk, None, b, r, True, (2, 8, 8), 1, body=body)
        host_us.setdefault(body, []).append(
            (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    print("host time per matmul_bn_act call at a tiny shape (wrapper, plan, "
          "ctypes, launch; the wg body also encodes its tensor maps): wg "
          + " / ".join(f"{t:.1f}" for t in host_us["wg"]) + " us, mma "
          + " / ".join(f"{t:.1f}" for t in host_us["mma"]) + " us")

    times = {shape: _time_mba(shape, n, gen)
             for shape, n in launches.items()}
    sums = _mba_sums(launches, times, f"one {FRAMES}-frame encode")
    return bf16_err, times, sums


def _time_mba(shape, n_launch, gen, variants=True):
    """The wg body, the plain version and the library (and, with
    ``variants``, the mma body as the earlier design and wg's other tile
    widths) timed in turns as CUDA graph replays at one R50 1x1 shape;
    returns the kernel record's timing keys."""
    B, H, W, K, N, res, stride, relu = shape
    x, w, _, b, r = _mba_inputs(B, H, W, K, N, res, stride, torch.bfloat16,
                                gen)
    w = w.to(torch.bfloat16)
    w_nk = w.reshape(N, K)
    Ho, Wo = H // stride, W // stride
    R = B * Ho * Wo
    xs = x[:, ::stride, ::stride].reshape(-1, K)
    r2 = None if r is None else r.reshape(-1, N)
    plan = mba._plan(R, K, N, stride, H, W, Wo, torch.bfloat16, True,
                     mba._n_sms(0))
    ms = _in_turns(
        lambda: mba.conv1x1_bn_act(x, w, None, b, stride, r, relu),
        lambda: mba.matmul_bn_act_reference(xs, w_nk.t(), None, b, r2,
                                            relu), 10,
        _mba_library(x, w, b, r, relu, stride),
        (lambda: mba._launch(x, w_nk, None, b, r, relu, (B, H, W), stride,
                             body="mma")) if variants else None, graph=True)
    widths = ""
    if variants:
        # the other wg tile widths, in turns with the planned one
        others = [t for t in mba.WG_TILE_NS if t != plan.tile_n]
        var = {t: [] for t in [plan.tile_n] + others}
        for t in [plan.tile_n] + others + others[::-1] + [plan.tile_n]:
            var[t].append(_time_ms(
                lambda: mba._launch(x, w_nk, None, b, r, relu, (B, H, W),
                                    stride, tile_n=t), 10, graph=True))
        widths = "; wg tile widths in turns: " + ", ".join(
            f"BN {tn} " + " / ".join(f"{v:.4f}" for v in vs)
            for tn, vs in var.items()) + " ms"
    nbytes = (R * K + K * N + R * N * (2 if res else 1)) * 2 + N * 4
    bound = _bound_ms(2 * R * K * N, nbytes)
    t = _timing(ms, bound)
    lib = "addmm" if stride == 1 else "cuDNN conv + bias"
    lib += (" + residual" if res else "") + (" + ReLU" if relu else "")
    mma = f", mma {_windows(ms, 'earlier')} ms" if variants else ""
    print(f"time bf16 matmul_bn_act R={R} K={K} N={N} residual={res} "
          f"stride={stride} relu={relu} (x{n_launch} per encode; device "
          f"time, CUDA graph of 10 calls): wg BN {plan.tile_n} "
          f"{_windows(ms, 'kernel')} ms "
          f"({2 * R * K * N / t['ms'] / 1e9:.1f} TFLOP/s, "
          f"{bound[0] / t['ms']:.1%} of bound){mma}, plain "
          f"{_windows(ms, 'plain')} ms, {lib} {_windows(ms, 'library')} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}){widths}")
    del x, w, w_nk, b, r, xs, r2
    torch.cuda.empty_cache()
    return t


def _mba_sums(launches, times, what):
    """{kernel, earlier, library, bound} ms summed over an encode's
    launches (launches x ms per shape)."""
    sums = {"kernel": 0.0, "earlier": 0.0, "library": 0.0, "bound": 0.0}
    for shape, n_launch in launches.items():
        t = times[shape]
        sums["kernel"] += n_launch * t["ms"]
        sums["library"] += n_launch * t["library_ms"]
        sums["bound"] += n_launch * t["bound_ms"]
        if t["earlier_ms"] is not None:
            sums["earlier"] += n_launch * t["earlier_ms"]
    earlier = (f", mma {sums['earlier']:.4f} ms" if sums["earlier"] else "")
    print(f"matmul_bn_act, {what}'s {sum(launches.values())} launches "
          f"(launches x ms, summed over the {len(launches)} shapes): wg "
          f"{sums['kernel']:.4f} ms{earlier}, library "
          f"{sums['library']:.4f} ms, bound {sums['bound']:.4f} ms "
          f"(wg at {sums['bound'] / sums['kernel']:.1%} of it)")
    return sums


def _stem_inputs(B, H, W, dtype, gen):
    # caffe-normalized pixels reach +-130; He-normal stem weights
    x = (torch.randn(B, H, W, 3, device="cuda", generator=gen) * 60).to(dtype)
    w = torch.randn(64, 3, 7, 7, device="cuda", generator=gen) * 0.025
    b = torch.randn(64, device="cuda", generator=gen)
    return x, w, b


# fused_stem_pool's cases: one 16-clip request's 32 frames and one clip's 2
# at the main path's 448^2, a small square, a non-square with W % 8 == 0
# (the tc body's 16-byte halo copies) and an odd size (its element-wise
# staging, partial tiles on both edges)
STEM_SHAPES = ((FRAMES, 448, 448), (2, 448, 448), (2, 64, 64), (1, 48, 80),
               (1, 37, 53))


def _stem_check(B, H, W, dtype, gen, body=None):
    """One case of the kernel against its plain version; returns (max abs
    error, body). The counters must show the body _plan chose (or
    ``body``)."""
    x, w, b = _stem_inputs(B, H, W, dtype, gen)
    ref = fsp.fused_stem_pool_reference(x, w, b)
    plan = fsp._plan(B, H, W, dtype, True, fsp._n_sms(0), body)
    before = (fsp.LAUNCHES, fsp.TC_LAUNCHES)
    out = (fsp.fused_stem_pool(x, w, b) if body is None
           else fsp._launch(x, w, b, body=body))
    torch.cuda.synchronize()
    ran = (fsp.LAUNCHES - before[0], fsp.TC_LAUNCHES - before[1])
    mag = F.conv2d(x.permute(0, 3, 1, 2).float().abs(),
                   w.to(dtype).float().abs(), None, 2, 3)
    mag = F.max_pool2d(mag + b.abs()[None, :, None, None], 3, 2, 1)
    what = (f"fused_stem_pool {(B, H, W)} -> {tuple(out.shape)}: body "
            f"{plan.body} ({plan.grid} blocks of {plan.threads}, "
            f"{plan.smem_bytes} B shared{', forced' if body else ''})")
    err = _check_close(what, out, ref, mag.permute(0, 2, 3, 1), dtype)
    if ran != (1, int(plan.body == "tc")):
        raise AssertionError(f"{what}: counters moved {ran}, plan {plan}")
    return err, plan.body


def phase_stem(gen):
    """Both bodies against the plain version at STEM_SHAPES, then tc, direct
    (as the earlier design), plain and cuDNN's conv + bias + ReLU +
    max_pool2d timed in turns as CUDA graph replays at 32 and 2 frames.
    Returns the worst bf16 error and {frames: timing}."""
    bf16_err = 0.0
    for B, H, W in STEM_SHAPES:
        for dtype, body in ((torch.float32, None), (torch.bfloat16, None),
                            (torch.bfloat16, "direct")):
            err, ran = _stem_check(B, H, W, dtype, gen, body)
            if dtype == torch.bfloat16:
                bf16_err = max(bf16_err, err)
                if body is None and ran != "tc":
                    raise AssertionError(f"bf16 stem {(B, H, W)} ran body "
                                         f"{ran}, not tc")
    times = {B: _time_stem(B, 448, 448, gen) for B in (FRAMES, 2)}
    return bf16_err, times


def _time_stem(B, H, W, gen, earlier=True):
    """tc, the plain version and cuDNN's conv + bias + ReLU + max_pool2d
    (and direct as the earlier design) timed in turns as CUDA graph
    replays at (B, H, W); returns the kernel record's timing keys."""
    x, w, b = _stem_inputs(B, H, W, torch.bfloat16, gen)
    xc = x.permute(0, 3, 1, 2)                        # channels_last view
    wc = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)[None, :, None, None]
    iters = 10 if B * H * W >= FRAMES * 448 * 448 else 40
    ms = _in_turns(
        lambda: fsp.fused_stem_pool(x, w, b),
        lambda: fsp.fused_stem_pool_reference(x, w, b), iters,
        lambda: F.max_pool2d(torch.relu(F.conv2d(xc, wc, None, 2, 3) + b16),
                             3, 2, 1),
        (lambda: fsp._launch(x, w, b, body="direct")) if earlier else None,
        graph=True)
    Hc, Wc = (H + 1) // 2, (W + 1) // 2               # conv output
    Hp, Wp = (Hc + 1) // 2, (Wc + 1) // 2             # pooled output
    nbytes = (B * H * W * 3 + B * Hp * Wp * 64) * 2 + 64 * 147 * 4 + 64 * 4
    flops = 2 * B * Hc * Wc * 64 * 147
    bound = _bound_ms(flops, nbytes)
    t = _timing(ms, bound)
    direct = f", direct {_windows(ms, 'earlier')} ms" if earlier else ""
    print(f"time bf16 fused_stem_pool {(B, H, W)} (device time, CUDA "
          f"graph of {iters} calls): tc {_windows(ms, 'kernel')} ms "
          f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, "
          f"{bound[0] / t['ms']:.1%} of bound){direct}, plain "
          f"{_windows(ms, 'plain')} ms, cuDNN conv+bias+relu+max_pool2d "
          f"{_windows(ms, 'library')} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    del x, w, b, xc, wc, b16
    torch.cuda.empty_cache()
    return t


@contextlib.contextmanager
def _planted(fault: str, block: resnet.Bottleneck):
    """The CNN's kernel form with one wiring fault in ``block``: "residual"
    runs its conv3 without the residual, "hw" swaps H and W of its output.
    For the check of the two forms' gap only; nothing else runs faulted."""
    bottleneck, conv = resnet.bottleneck_kernels, resnet.conv1x1_bn_act

    def no_residual(*args, residual=None, **kwargs):
        return conv(*args, **kwargs)

    def faulty(x, p, stride):
        if p is not block:
            return bottleneck(x, p, stride)
        if fault == "hw":
            return bottleneck(x, p, stride).transpose(1, 2)
        resnet.conv1x1_bn_act = no_residual
        try:
            return bottleneck(x, p, stride)
        finally:
            resnet.conv1x1_bn_act = conv

    resnet.bottleneck_kernels = faulty
    try:
        yield
    finally:
        resnet.bottleneck_kernels = bottleneck


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _check_cnn_forms(what, model, encode, score):
    """Grid features of the kernel form against the cuDNN form on the same
    pixels (``encode(form)``), within FEAT_REL; then the kernel form with
    each planted fault, which must land outside it. ``score(features)``
    gives the probabilities, to show what PROB_ATOL alone would see."""
    ref = encode("cudnn")
    ref_probs = score(ref)
    feats = encode("kernels")
    gap = _rel_gap(feats, ref)
    before = (mba.LAUNCHES, mba.WG_LAUNCHES)
    with _mba_body("mma"):
        body_gap = _rel_gap(encode("kernels"), feats)
    ran = (mba.LAUNCHES - before[0], mba.WG_LAUNCHES - before[1])
    if ran[0] == 0 or ran[1] != 0:
        raise AssertionError(f"{what}: the forced mma.sync encode launched "
                             f"(all, wgmma) {ran}")
    before = (fsp.LAUNCHES, fsp.TC_LAUNCHES)
    with _stem_body("direct"):
        stem_gap = _rel_gap(encode("kernels"), feats)
    ran = (fsp.LAUNCHES - before[0], fsp.TC_LAUNCHES - before[1])
    if ran[0] == 0 or ran[1] != 0:
        raise AssertionError(f"{what}: the forced direct-stem encode "
                             f"launched (all, tc) {ran}")
    print(f"{what}: grid features, kernel form vs cuDNN form: relative gap "
          f"{gap:.3e}; matmul_bn_act's wgmma body vs its mma.sync body "
          f"(forced): {body_gap:.3e}; the stem's tc body vs its direct body "
          f"(forced): {stem_gap:.3e} (bound {FEAT_REL})")
    if not gap <= FEAT_REL:
        raise AssertionError(f"{what}: the CNN's two forms' grid features "
                             f"differ by {gap} > {FEAT_REL}")
    if not body_gap <= FEAT_REL:
        raise AssertionError(f"{what}: matmul_bn_act's two bodies' grid "
                             f"features differ by {body_gap} > {FEAT_REL}")
    if not stem_gap <= FEAT_REL:
        raise AssertionError(f"{what}: the stem's two bodies' grid features "
                             f"differ by {stem_gap} > {FEAT_REL}")
    r50 = model.cnn.resnet
    for fault, name, block in (("residual", "res4[2]", r50.res4[2]),
                               ("hw", "res3[1]", r50.res3[1])):
        with _planted(fault, block):
            bad = encode("kernels")
        bad_gap = _rel_gap(bad, ref)
        prob_gap = float(np.abs(score(bad) - ref_probs).max())
        print(f"{what}: planted fault ({fault} in {name}): relative gap "
              f"{bad_gap:.3e}, probabilities max_abs_diff {prob_gap:.3e} "
              f"(PROB_ATOL {PROB_ATOL})")
        if not bad_gap > FEAT_REL:
            raise AssertionError(f"{what}: planted fault {fault} in {name} "
                                 f"moved the grid features by only "
                                 f"{bad_gap} <= {FEAT_REL}")
    return gap


def _captions(rng, n):
    return [" ".join(rng.choice(CAPTION_WORDS, size=rng.integers(5, 13)))
            for _ in range(n)]


def _reset_counts():
    fa.LAUNCHES = fa.TC_LAUNCHES = fa.SHARD_HEADS_LAUNCHES = 0
    mba.LAUNCHES = mba.WG_LAUNCHES = fsp.LAUNCHES = fsp.TC_LAUNCHES = 0


def _counts():
    """(attention, matmul_bn_act, fused_stem_pool, attention on the
    tensor-core body, matmul_bn_act on the wgmma body, fused_stem_pool on
    the tensor-core body) launches."""
    return (fa.LAUNCHES, mba.LAUNCHES, fsp.LAUNCHES, fa.TC_LAUNCHES,
            mba.WG_LAUNCHES, fsp.TC_LAUNCHES)


def _expect(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got} launches, expected {want}")


def _model(cfg, verbose=True):
    """The seeded random-weight model, the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = clipbert.init_clipbert(cfg, "retrieval", generator=gen,
                                   device="cuda")
    clipbert.fold_cnn_bn_scales(model)
    model.eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"model: {n_params} parameters, {cfg.num_hidden_layers} "
              f"layers, hidden {cfg.hidden_size}, random init on cuda in "
              f"{time.perf_counter() - t0:.2f} s, frozen BN folded")
    return model


def phase_slice(model, cfg, tok):
    rng = np.random.default_rng(0)
    caps = _captions(rng, max(REQUEST_SIZES))
    common = dict(device="cuda", compute_dtype=torch.bfloat16, num_frm=2,
                  max_img_size=448, max_txt_len=20, max_captions=32)
    scorers = {(nc, form): RetrievalScorer(model, cfg, tok, n_clips=nc,
                                           use_kernels=form == "kernels",
                                           **common)
               for nc in (1, 16) for form in ("kernels", "cudnn")}
    frames = {nc: rng.integers(0, 256, (nc * 2, 240, 320, 3), np.uint8)
              for nc in (1, 16)}
    for (nc, form), sc in scorers.items():
        t0 = time.perf_counter()
        sc.warmup(((240, 320),))
        torch.cuda.synchronize()
        print(f"warmup {nc} clip(s), {form}: "
              f"{time.perf_counter() - t0:.2f} s")

    # ---- the main path: counts from 0, read right after ------------------
    _reset_counts()
    lat = {nc: {n: [] for n in REQUEST_SIZES} for nc in frames}
    n_calls = 0
    for nc in frames:
        sc = scorers[(nc, "kernels")]
        for _ in range(REPEATS):
            for n in REQUEST_SIZES:
                before = _counts()
                t0 = time.perf_counter()
                feats = sc.encode_frames(frames[nc])
                probs = sc.score(None, caps[:n], features=feats)
                lat[nc][n].append(time.perf_counter() - t0)
                n_calls += 1
                if probs.shape != (n,) or not np.isfinite(probs).all() or \
                        not ((probs >= 0) & (probs <= 1)).all():
                    raise AssertionError(f"{nc} clips, {n} captions: bad "
                                         f"probabilities {probs}")
                d = [a - b for a, b in zip(_counts(), before)]
                _expect("scoring call, attention", d[0],
                        cfg.num_hidden_layers)
                _expect("scoring call, attention on the tensor-core body",
                        d[3], cfg.num_hidden_layers)
                _expect("encode, matmul_bn_act", d[1], MBA_PER_ENCODE)
                _expect("encode, matmul_bn_act on the wgmma body", d[4],
                        MBA_PER_ENCODE)
                _expect("encode, fused_stem_pool", d[2], 1)
                _expect("encode, fused_stem_pool on the tensor-core body",
                        d[5], 1)
    launches = _counts()
    print(f"serving path: {n_calls} requests launched attention "
          f"{launches[0]} ({launches[3]} on the tensor-core body), "
          f"matmul_bn_act {launches[1]} ({launches[4]} on the wgmma body) "
          f"and fused_stem_pool {launches[2]} ({launches[5]} on the "
          f"tensor-core body) times ({cfg.num_hidden_layers}, "
          f"{MBA_PER_ENCODE} and 1 per request)")
    for nc in frames:
        per = ", ".join(f"{n} caption(s) {np.median(lat[nc][n]) * 1e3:.2f} ms"
                        for n in REQUEST_SIZES)
        allp = np.median([x for v in lat[nc].values() for x in v]) * 1e3
        print(f"p50 request latency, {nc} clip(s), kernel form "
              f"(encode_frames + score, {REPEATS} repeats): {per}; all "
              f"{allp:.2f} ms")

    # ---- the CNN's kernel form against its cuDNN form, in turns ----------
    for nc in frames:
        enc = {"kernels": [], "cudnn": []}
        req = {"kernels": [], "cudnn": []}
        feats = {}
        for _ in range(REPEATS):
            for form in ("kernels", "cudnn", "cudnn", "kernels"):
                sc = scorers[(nc, form)]
                t0 = time.perf_counter()
                feats[form] = sc.encode_frames(frames[nc])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                sc.score(None, caps[:5], features=feats[form])
                t2 = time.perf_counter()
                enc[form].append(t1 - t0)
                req[form].append(t2 - t0)
        probs = {f: scorers[(nc, f)].score(None, caps[:5],
                                           features=feats[f])
                 for f in feats}
        err = float(np.abs(probs["kernels"] - probs["cudnn"]).max())
        print(f"{nc} clip(s), 5 captions, kernel form vs cuDNN form in "
              f"turns ({2 * REPEATS} requests each): encode p50 "
              f"{np.median(enc['kernels']) * 1e3:.2f} vs "
              f"{np.median(enc['cudnn']) * 1e3:.2f} ms, request p50 "
              f"{np.median(req['kernels']) * 1e3:.2f} vs "
              f"{np.median(req['cudnn']) * 1e3:.2f} ms; probabilities "
              f"max_abs_diff {err:.3e}")
        if err > PROB_ATOL:
            raise AssertionError(f"CNN kernel and cuDNN forms disagree by "
                                 f"{err} > {PROB_ATOL}")
        _check_cnn_forms(
            f"serving, {nc} clip(s)", model,
            lambda f: scorers[(nc, f)].encode_frames(frames[nc]),
            lambda feats: scorers[(nc, "kernels")].score(None, caps[:5],
                                                         features=feats))

    # ---- the same request through the plain attention path (a test call)
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse")
    plain_step = steps.make_text_prob_step(cfg, ts, torch.bfloat16,
                                           fused_attn=False)
    for nc in frames:
        sc = scorers[(nc, "kernels")]
        feats = sc.encode_frames(frames[nc])
        n = 5
        ids, mask = sc._pad_texts(caps[:n], _pow2_bucket(n, 32))
        plain = plain_step(sc.model, feats, ids, mask)[0, :n].cpu().numpy()
        kern = sc.score(None, caps[:n], features=feats)
        err = float(np.abs(plain - kern).max())
        print(f"{nc} clip(s), {n} captions: kernel path {np.round(kern, 5)} "
              f"plain attention path {np.round(plain, 5)} max_abs_err "
              f"{err:.3e}")
        if err > PROB_ATOL:
            raise AssertionError(f"kernel and plain scoring paths disagree "
                                 f"by {err} > {PROB_ATOL}")
    return launches


def _eval_store(d: str, rng):
    """16 seeded 240x320 JPEG-sequence videos (32 frames at 2 fps) in a
    CBPK store, and 72 captions: caption i describes video i % 16."""
    path = os.path.join(d, "videos.cbpk")
    t0 = time.perf_counter()
    with store.PackWriter(path) as w:
        for i in range(EVAL_VIDEOS):
            base = rng.integers(0, 256, (1, 240, 320, 3))
            noise = rng.integers(-40, 41, (32, 240, 320, 3))
            fr = np.clip(base + noise, 0, 255).astype(np.uint8)
            w.put(f"video{i}", video.encode_jseq_from_array(fr, fps=2))
    rows = [{"id": i, "vid_id": f"video{i % EVAL_VIDEOS}",
             "txt": c} for i, c in enumerate(_captions(rng, EVAL_CAPTIONS))]
    print(f"eval store: {EVAL_VIDEOS} videos, {EVAL_CAPTIONS} captions, "
          f"{os.path.getsize(path) / 1e6:.1f} MB, made in "
          f"{time.perf_counter() - t0:.2f} s")
    return path, rows


def _check_eval_cnn_forms(model, model_cfg, cfg, ds):
    """_check_cnn_forms on the first video group's pixels, prepared as
    inference_retrieval prepares them, scored against its first 8
    captions."""
    vb, nc = cfg.inference_video_batch_size, cfg.inference_n_clips
    vis, src_hw = transforms.collate_visual([ds[v] for v in range(vb)])
    vis = torch.from_numpy(vis).cuda()
    mean, std = common.pixel_mean_std(cfg)
    if src_hw is not None:
        px = transforms.resize_pad_normalize(
            vis, torch.from_numpy(src_hw).cuda(), cfg.max_img_size, mean,
            std, torch.bfloat16)
    else:
        px = transforms.normalize_pixels(vis, mean, std, torch.bfloat16)
    px = px.reshape((vb * nc, ds.num_frm) + px.shape[2:])
    encode = {f: steps.make_visual_encode_step(torch.bfloat16,
                                               f == "kernels")
              for f in ("kernels", "cudnn")}
    ts = steps.TaskSettings(head_type="retrieval", loss_type=cfg.loss_type,
                            score_agg_func=cfg.score_agg_func)
    prob = steps.make_text_prob_step(model_cfg, ts, torch.bfloat16)
    caps = ds.encode_all_captions()
    ids, mask = (torch.from_numpy(caps[k][:8]).cuda()
                 for k in ("text_input_ids", "text_input_mask"))
    _check_cnn_forms(
        "eval, first video group", model, lambda f: encode[f](model, px),
        lambda feats: prob(model, feats.reshape((vb, nc) + feats.shape[1:]),
                           ids, mask).cpu().numpy())


def _eval_dataset(rows, tok, path, cfg):
    return VideoRetrievalEvalDataset(
        rows, tok, store.open_store(path), fps=cfg.fps, num_frm=cfg.num_frm,
        max_img_size=cfg.max_img_size, max_txt_len=cfg.max_txt_len,
        ensemble_n_clips=cfg.inference_n_clips,
        device_preprocess=cfg.device_preprocess)


def _check_matrix(sm):
    if sm.shape != (EVAL_VIDEOS, EVAL_CAPTIONS) or \
            not np.isfinite(sm).all() or not ((sm >= 0) & (sm <= 1)).all():
        raise AssertionError(f"bad score matrix {sm.shape}")


def _stats_json(stats):
    return json.dumps({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in stats.items()})


def phase_eval(model, model_cfg, tok, cfg, d):
    """Phase 7 on a store made under ``d`` (kept for phase 11). Returns the
    main path's launches, the kernel form's score matrix and wall time, the
    store's path and the caption rows."""
    rng = np.random.default_rng(5)
    results, walls = {}, {}
    path, rows = _eval_store(d, rng)
    n_cap_batches = -(-EVAL_CAPTIONS // cfg.inference_batch_size)
    for form in ("kernels", "cudnn"):
        ds = _eval_dataset(rows, tok, path, cfg)
        stats = {}
        if form == "kernels":
            # ---- the main path: counts from 0, read right after ----
            _reset_counts()
        t0 = time.perf_counter()
        m = inference_retrieval(cfg, model_cfg, model, ds, torch.bfloat16,
                                stats, use_kernels=form == "kernels")
        walls[form] = time.perf_counter() - t0
        if form == "kernels":
            launches = _counts()
            g = stats["n_groups"]
            _expect("eval, attention", launches[0],
                    model_cfg.num_hidden_layers * g * n_cap_batches)
            _expect("eval, attention on the tensor-core body", launches[3],
                    launches[0])
            _expect("eval, matmul_bn_act", launches[1], MBA_PER_ENCODE * g)
            _expect("eval, matmul_bn_act on the wgmma body", launches[4],
                    MBA_PER_ENCODE * g)
            _expect("eval, fused_stem_pool", launches[2], g)
            _expect("eval, fused_stem_pool on the tensor-core body",
                    launches[5], g)
            print(f"eval path: {g} video groups x {n_cap_batches} caption "
                  f"minibatches launched attention {launches[0]} "
                  f"({launches[3]} on the tensor-core body), matmul_bn_act "
                  f"{launches[1]} ({launches[4]} on the wgmma body) and "
                  f"fused_stem_pool {launches[2]} ({launches[5]} on the "
                  f"tensor-core body) times")
        _check_matrix(m["score_matrix"])
        if ds.n_fallbacks:
            raise AssertionError(f"{ds.n_fallbacks} videos did not decode")
        recall = {k: v for k, v in m.items() if k != "score_matrix"}
        print(f"eval, {form} form: wall {walls[form]:.3f} s; stage stats "
              + _stats_json(stats))
        print(f"eval, {form} form: R@K {json.dumps(recall)}")
        results[form] = m["score_matrix"]
    _check_eval_cnn_forms(model, model_cfg, cfg, ds)
    err = float(np.abs(results["kernels"] - results["cudnn"]).max())
    print(f"eval score matrices, kernel form vs cuDNN form: max_abs_diff "
          f"{err:.3e} (bound {PROB_ATOL})")
    if err > PROB_ATOL:
        raise AssertionError(f"eval score matrices disagree by {err}")
    return launches, results["kernels"], walls["kernels"], path, rows


BENCH_UNITS = ((16, 8), (1, 128))     # (clips, videos): 256 frames a call


def _bench_unit(rng, cfg, nc, bv):
    """bench.py's unit: mil_forward's task settings and a batch of bv
    videos x nc clips of 2 random bf16 448^2 frames, 20 text tokens."""
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse", train_n_clips=nc)
    batch = {
        "text_input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (bv, 20))).cuda(),
        "text_input_mask": torch.ones(bv, 20, dtype=torch.int64,
                                      device="cuda"),
        "visual_inputs": (torch.from_numpy(rng.standard_normal(
            (bv, nc * 2, 448, 448, 3), np.float32)) * 0.5).to(
            "cuda", torch.bfloat16)}
    return ts, batch


def phase_bench(model, cfg):
    """bench.py's unit (mil_forward, no fused attention, folded BN, bf16) at
    8 videos x 16 clips and 128 videos x 1 clip, both CNN forms in turns."""
    rng = np.random.default_rng(0)
    for nc, bv in BENCH_UNITS:
        ts, batch = _bench_unit(rng, cfg, nc, bv)
        runs = {}
        for form in ("kernels", "cudnn"):
            runs[form] = (lambda f=form: steps.mil_forward(
                model, cfg, ts, batch, torch.bfloat16,
                use_kernels=f == "kernels"))
        ms = {"kernels": [], "cudnn": []}
        for form in ("kernels", "cudnn", "cudnn", "kernels"):
            ms[form].append(_time_ms(runs[form], 2))
        rate = {f: [bv * nc / (t / 1e3) for t in v] for f, v in ms.items()}
        print(f"bench unit {bv} videos x {nc} clip(s): kernel form "
              + " / ".join(f"{r:.1f}" for r in rate["kernels"])
              + " clips/s, cuDNN form "
              + " / ".join(f"{r:.1f}" for r in rate["cudnn"]) + " clips/s")
        del batch, runs
        torch.cuda.empty_cache()


def _retrieval_ts():
    return steps.TaskSettings(head_type="retrieval", loss_type="ce",
                              score_agg_func="lse")


def _rank_setup():
    """A spawned rank's preamble, before its first CUDA call: this card,
    TF32 off as in phase 1, and an allocator that grows its segments, so
    that two eval processes' activations fit on the one card beside the
    parent without stranding blocks."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _final_hidden(model, cfg, feats, ids, mask, fused, mesh, dtype):
    """The final hidden states, computed in ``dtype``, of the scoring batch
    make_text_prob_step builds from this rank's data shard of the
    captions: (nc * B_t_local, S, D), row c * B_t_local + t pairing clip c
    with caption t."""
    if mesh is not None:
        n = ids.shape[0] // mesh.n_data
        ids, mask = (t[mesh.data_idx * n:(mesh.data_idx + 1) * n]
                     for t in (ids, mask))
    B_v, nc = feats.shape[:2]
    B_t = ids.shape[0]
    f = feats.reshape((B_v * nc,) + feats.shape[2:])
    with torch.inference_mode():
        hidden, _ = clipbert.base_forward(
            model.transformer.bert, cfg, ids.repeat(B_v * nc, 1),
            mask.repeat(B_v * nc, 1), f.repeat_interleave(B_t, dim=0),
            dtype, fused_attn=fused, mesh=mesh)
    return hidden


@contextlib.contextmanager
def _dropped_reduce(layer, active: bool):
    """The planted fault of phase 10, on the ranks where ``active``: the
    attention-output product of ``layer`` keeps this rank's partial sum.
    Its all-reduce still runs, on a copy, so the collectives stay paired
    across the ranks."""
    real = bert.dense_row_parallel
    target = layer.attention.output.dense.weight

    def faulty(x, w, b, group):
        if w is not target:
            return real(x, w, b, group)
        y = mm_f32(x.reshape(-1, x.shape[-1]), w.to(x.dtype).t())
        torch.distributed.all_reduce(y.clone(), group=group)
        return (y + b.float()).to(x.dtype).reshape(x.shape[:-1]
                                                   + (w.shape[0],))

    if active:
        bert.dense_row_parallel = faulty
    try:
        yield
    finally:
        bert.dense_row_parallel = real


@contextlib.contextmanager
def _encoder_output(kept: list):
    """Appends the encoder's final hidden states of each forward run inside
    to ``kept``."""
    real = bert.encoder

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        kept.append(out)
        return out

    bert.encoder = keep
    try:
        yield kept
    finally:
        bert.encoder = real


def _tp_work(rank, model_parallel, cfg, feats, ids, mask):
    """Phase 10 in one rank: the seeded model Megatron-split over a (world
    / model_parallel, model_parallel) mesh scores the captions through
    make_text_prob_step(mesh=); returns what the parent checks."""
    t_start = time.perf_counter()
    mesh = make_mesh(model_parallel)
    model = shard_model(_model(cfg, verbose=False), mesh)
    feats, ids, mask = (t.cuda() for t in (feats, ids, mask))
    t_model = time.perf_counter()
    step = steps.make_text_prob_step(cfg, _retrieval_ts(), torch.bfloat16,
                                     mesh=mesh)
    shapes = set()
    kernel = fa.fused_attention

    def recorded(q, k, v, key_bias, scale):
        shapes.add((tuple(q.shape), q.stride(1)))
        return kernel(q, k, v, key_bias, scale)

    fa.fused_attention = recorded
    # ---- the main path: counts from 0, read right after ----------------
    _reset_counts()
    with _encoder_output([]) as kept:
        probs = step(model, feats, ids, mask)
    torch.cuda.synchronize()
    launches = (fa.LAUNCHES, fa.SHARD_HEADS_LAUNCHES, fa.TC_LAUNCHES)
    fa.fused_attention = kernel
    ms = []
    for _ in range(TP_REPEATS):
        t0 = time.perf_counter()
        step(model, feats, ids, mask)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    hidden = {torch.bfloat16: kept[0].cpu(),
              torch.float32: _final_hidden(model, cfg, feats, ids, mask,
                                           True, mesh, torch.float32).cpu()}
    with _dropped_reduce(model.transformer.bert.encoder.layers[FAULT_LAYER],
                         rank == 0), _encoder_output([]) as kept:
        bad_probs = step(model, feats, ids, mask)
        bad_hidden = {torch.bfloat16: kept[0].cpu(),
                      torch.float32: _final_hidden(
                          model, cfg, feats, ids, mask, True, mesh,
                          torch.float32).cpu()}
    return {"idx": (mesh.data_idx, mesh.model_idx), "launches": launches,
            "shapes": sorted(shapes), "probs": probs.cpu(),
            "bad_probs": bad_probs.cpu(), "hidden": hidden,
            "bad_hidden": bad_hidden, "ms": ms,
            "setup_s": t_model - t_start,
            "run_s": time.perf_counter() - t_model}


def _eval_work(run_cfg, tok, path, rows, cfg):
    """Phase 11 in one process: inference_retrieval on phase 7's store."""
    model = _model(cfg, verbose=False)
    ds = _eval_dataset(rows, tok, path, run_cfg)
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts from 0, read right after ----------------
    _reset_counts()
    t0 = time.perf_counter()
    m = inference_retrieval(run_cfg, cfg, model, ds, torch.bfloat16, stats)
    return {"m": m, "stats": stats, "launches": _counts(),
            "wall": time.perf_counter() - t0, "fallbacks": ds.n_fallbacks,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _rank(rank, world, model_parallel, cfg, tp_inputs, eval_inputs):
    """One spawned rank: phase 10's work, then phase 11's when
    ``eval_inputs`` is given (phase 10's pair of ranks are phase 11's two
    processes, which saves a spawn)."""
    _rank_setup()
    out = {"tp": _tp_work(rank, model_parallel, cfg, *tp_inputs)}
    if eval_inputs is not None:
        torch.cuda.empty_cache()
        out["eval"] = _eval_work(*eval_inputs, cfg=cfg)
    return out


def _shard_heads_vs_plain(gen):
    """fused_attention_shard_heads against its plain version at the head
    shards of a 2-way and a 4-way model axis (B = 1 video x 16 clips x 8
    captions, S = 69, 6 and 3 heads, strided views of the rank's merged QKV
    with row pitch 3 D / n_model): the tensor-core body in bf16, v2 in
    fp32; timed at 6 heads beside the v2 body and SDPA. The kernel
    communicates nothing, so a mesh that only describes the rank's
    layout is all it needs here."""
    B, S, dh, heads = TP_CLIPS * TP_CAPTIONS, 69, 64, 12
    bf16_err = 0.0
    for n_model in (2, 4):
        H = heads // n_model
        mesh = Mesh(1, n_model)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = _inputs(B, S, H, dh, dtype, "merged-qkv views",
                                    gen)
            scale = dh ** -0.5
            ref = fa.fused_attention_reference(q, k, v, bias, scale)
            tc_before = fa.TC_LAUNCHES
            out = fa.fused_attention_shard_heads(q, k, v, bias, scale, mesh,
                                                 heads)
            torch.cuda.synchronize()
            body = "tc" if fa.TC_LAUNCHES > tc_before else "v2"
            if body != ("tc" if dtype == torch.bfloat16 else "v2"):
                raise AssertionError(f"shard_heads {dtype} ran body {body}")
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                ok = bool((diff <= FP32_TOL + FP32_TOL * ref.float().abs())
                          .all())
            else:
                ok = err <= BF16_ATOL
                bf16_err = max(bf16_err, err)
            print(f"shard_heads vs plain {(B, S, H, dh)} row pitch "
                  f"{q.stride(1)} {str(dtype)[6:]}: body {body}: "
                  f"max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_attention_shard_heads disagrees "
                                     f"with its plain version at "
                                     f"{(B, S, H, dh)} {dtype}: {err}")
    H = heads // 2
    q, k, v, bias = _inputs(B, S, H, dh, torch.bfloat16, "merged-qkv views",
                            gen)
    scale = dh ** -0.5
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = bias[:, None, None, :].to(torch.bfloat16)
    ms = _in_turns(
        lambda: fa.fused_attention_shard_heads(q, k, v, bias, scale,
                                               Mesh(1, 2), heads),
        lambda: fa.fused_attention_reference(q, k, v, bias, scale), 200,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, mask,
                                               scale=scale),
        lambda: fa._launch(q, k, v, bias, scale, body="v2"), graph=True)
    bound = _bound_ms(4 * B * H * S * S * dh, 4 * B * S * H * dh * 2
                      + B * S * 4)
    print(f"time bf16 shard_heads {(B, S, H, dh)} row pitch {q.stride(1)} "
          f"(device time, CUDA graph of 200 calls): "
          f"tc body {_windows(ms, 'kernel')} ms, v2 body "
          f"{_windows(ms, 'earlier')} ms, plain {_windows(ms, 'plain')} ms, "
          f"SDPA {_windows(ms, 'library')} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    torch.cuda.empty_cache()
    return bf16_err, _timing(ms, bound)


def phase_tp(model, cfg, tok, d, gen, eval_inputs):
    """Phase 10; its pair of ranks then runs phase 11's eval on
    ``eval_inputs``, whose results are returned for phase 11's checks."""
    shard_err, shard_time = _shard_heads_vs_plain(gen)
    rng = np.random.default_rng(7)
    px = (torch.randn(TP_CLIPS, 2, 448, 448, 3, device="cuda",
                      generator=gen) * 0.5).to(torch.bfloat16)
    feats = steps.make_visual_encode_step(torch.bfloat16)(model, px)
    feats = feats.reshape((1, TP_CLIPS) + feats.shape[1:])
    enc = tok.batch_encode(_captions(rng, TP_CAPTIONS), TXT_LEN)
    ids, mask = (torch.from_numpy(enc[k].astype(np.int64)).cuda()
                 for k in ("input_ids", "attention_mask"))
    step = steps.make_text_prob_step(cfg, _retrieval_ts(), torch.bfloat16)
    with _encoder_output([]) as kept:
        ref_probs = step(model, feats, ids, mask).cpu()
    ms = []
    for _ in range(TP_REPEATS):
        t0 = time.perf_counter()
        step(model, feats, ids, mask)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ref_hidden = {torch.bfloat16: kept[0],
                  torch.float32: _final_hidden(model, cfg, feats, ids, mask,
                                               True, None, torch.float32)}
    S = ref_hidden[torch.bfloat16].shape[1]
    print(f"tensor-parallel scoring: 1 video x {TP_CLIPS} clips x "
          f"{TP_CAPTIONS} captions, S = {S}; one process, fused kernel: "
          f"p50 {np.median(ms):.2f} ms per call; its final hidden states, "
          f"bf16 vs fp32: relative gap "
          f"{_rel_gap(*ref_hidden.values()):.3e} (bf16's own rounding)")
    ref_hidden = {dt: h.reshape(TP_CLIPS, TP_CAPTIONS, S, -1)
                  for dt, h in ref_hidden.items()}
    torch.cuda.empty_cache()       # the ranks need the parent's spare cache
    tp_inputs = (feats.cpu(), ids.cpu(), mask.cpu())
    rank_launches = eval_outs = None
    for world, model_parallel in ((2, 2), (4, 2)):
        n_data = world // model_parallel
        what = f"{n_data} data x {model_parallel} model"
        t0 = time.perf_counter()
        outs = spawn_ranks(_rank, world,
                           (model_parallel, cfg, tp_inputs,
                            eval_inputs if world == 2 else None),
                           backend="gloo",
                           workdir=os.path.join(d, f"ranks{world}"),
                           timeout_s=RANK_TIMEOUT_S, threads=2)
        print(f"{what}: {world} ranks on cuda:0 over gloo (chosen "
              f"explicitly: NCCL refuses two ranks on one device), "
              f"{time.perf_counter() - t0:.2f} s from spawn to join"
              + (", phase 11's eval included" if world == 2 else ""))
        if world == 2:
            eval_outs = [out["eval"] for out in outs]
        outs = [out["tp"] for out in outs]
        gaps = {dt: [] for dt in DTYPES}
        bad_gaps = {dt: [] for dt in DTYPES}
        bad_probs, faults = [], []
        for r, out in enumerate(outs):
            rows = slice(out["idx"][0] * TP_CAPTIONS // n_data,
                         (out["idx"][0] + 1) * TP_CAPTIONS // n_data)
            for dt in DTYPES:
                shard = ref_hidden[dt][:, rows].reshape(
                    (-1,) + ref_hidden[dt].shape[2:])
                gaps[dt].append(_rel_gap(out["hidden"][dt].cuda(), shard))
                bad_gaps[dt].append(_rel_gap(out["bad_hidden"][dt].cuda(),
                                             shard))
                if not gaps[dt][-1] <= TP_HIDDEN_REL[dt]:
                    faults.append(f"rank {r}: final hidden states "
                                  f"({str(dt)[6:]}) differ by "
                                  f"{gaps[dt][-1]} > {TP_HIDDEN_REL[dt]}")
            bad_probs.append(float((out["bad_probs"] - ref_probs).abs()
                                   .max()))
            err = float((out["probs"] - ref_probs).abs().max())
            heads = {shape[2] for shape, _ in out["shapes"]}
            pitch = {p for _, p in out["shapes"]}
            print(f"{what}, rank {r} at {out['idx']}: launches "
                  f"(fused_attention, shard_heads, tensor-core body) "
                  f"{out['launches']}, q "
                  f"{[s for s, _ in out['shapes']]} row pitch {pitch}; "
                  f"p50 {np.median(out['ms']):.2f} ms per call; "
                  f"probabilities max_abs_err {err:.3e}; final hidden "
                  f"relative gap bf16 {gaps[torch.bfloat16][-1]:.3e}, fp32 "
                  f"{gaps[torch.float32][-1]:.3e}; set-up "
                  f"{out['setup_s']:.2f} s, run {out['run_s']:.2f} s")
            want = cfg.num_hidden_layers
            if out["launches"] != (want, want, want):
                faults.append(f"rank {r}: launches {out['launches']}, "
                              f"expected {(want, want, want)}")
            if heads != {cfg.num_attention_heads // model_parallel} or \
                    pitch != {3 * cfg.hidden_size // model_parallel}:
                faults.append(f"rank {r}: kernel saw {out['shapes']}")
            if out["probs"].shape != ref_probs.shape or err > PROB_ATOL:
                faults.append(f"rank {r}: probabilities "
                              f"{tuple(out['probs'].shape)} differ by {err}"
                              f" > {PROB_ATOL}")
        for dt in DTYPES:
            bad, bound = max(bad_gaps[dt]), TP_HIDDEN_REL[dt]
            print(f"{what}: planted fault (layer {FAULT_LAYER}'s attention-"
                  f"output reduce dropped on rank 0), {str(dt)[6:]}: final "
                  f"hidden relative gap {bad:.3e} ({bad / bound:.1f}x the "
                  f"bound {bound})")
            if not bad >= 3 * bound:
                faults.append(f"the planted fault moved the {dt} hidden "
                              f"states by only {bad} < 3 x {bound}")
        print(f"{what}: planted fault, probabilities max_abs_diff "
              f"{max(bad_probs):.3e} (PROB_ATOL {PROB_ATOL})")
        if faults:
            raise AssertionError(f"{what}: " + "; ".join(faults))
        if rank_launches is None:
            rank_launches = outs[0]["launches"][1]
    return rank_launches, shard_err, shard_time, eval_outs


def phase_multiprocess_eval(cfg, run_cfg, tok, path, rows, single,
                            single_wall, outs):
    """Phase 11's checks on the two processes' results (``outs``, run by
    phase 10's pair of ranks on cuda:0 over gloo)."""
    print(f"multi-process eval: 2 processes on cuda:0 over gloo; one "
          f"process took {single_wall:.3f} s in phase 7")
    n_cap_batches = -(-EVAL_CAPTIONS // run_cfg.inference_batch_size)
    sm = outs[0]["m"]["score_matrix"]
    for r, out in enumerate(outs):
        st, g = out["stats"], out["stats"]["n_groups"]
        print(f"multi-process eval, rank {r}: {st['n_videos']} videos in "
              f"{g} group(s), wall {out['wall']:.3f} s, peak device "
              f"memory allocated {out['peak_gb']:.2f} GiB, launches "
              f"{out['launches']}; stage stats {_stats_json(st)}")
        _expect(f"eval rank {r}, attention", out["launches"][0],
                cfg.num_hidden_layers * g * n_cap_batches)
        _expect(f"eval rank {r}, attention on the tensor-core body",
                out["launches"][3], out["launches"][0])
        _expect(f"eval rank {r}, matmul_bn_act", out["launches"][1],
                MBA_PER_ENCODE * g)
        _expect(f"eval rank {r}, matmul_bn_act on the wgmma body",
                out["launches"][4], MBA_PER_ENCODE * g)
        _expect(f"eval rank {r}, fused_stem_pool", out["launches"][2], g)
        _expect(f"eval rank {r}, fused_stem_pool on the tensor-core body",
                out["launches"][5], g)
        if out["fallbacks"]:
            raise AssertionError(f"rank {r}: {out['fallbacks']} videos did "
                                 "not decode")
        if not np.array_equal(out["m"]["score_matrix"], sm):
            raise AssertionError("the processes' merged matrices differ")
    if sum(out["stats"]["n_videos"] for out in outs) != EVAL_VIDEOS:
        raise AssertionError("the processes did not share the videos out "
                             "once each")
    _check_matrix(sm)
    err = float(np.abs(sm - single).max())
    ds = _eval_dataset(rows, tok, path, run_cfg)
    vid_pos = {v: i for i, v in enumerate(ds.video_ids)}
    gt = [vid_pos[ds.gt_cap_id2vid_id[i]] for i in range(EVAL_CAPTIONS)]
    m = eval_metrics.retrieval_metrics(sm.T, gt)
    want = {f"t2v_{k}": v for k, v in m["text2video"].items()}
    want.update({f"v2t_{k}": v for k, v in m["video2text"].items()})
    got = {k: v for k, v in outs[0]["m"].items() if k != "score_matrix"}
    print(f"multi-process eval: merged matrix vs phase 7's: max_abs_diff "
          f"{err:.3e} (must be bit-identical); R@K {json.dumps(got)}")
    # Each process runs the same group and minibatch shapes as phase 7, so
    # every row is the same computation: any difference is a row scored from
    # the wrong frames or filed under the wrong video (random-weight scores
    # all sit near one value, so a tolerance would not see it)
    if not np.array_equal(sm, single):
        raise AssertionError(f"merged score matrix differs from phase 7's "
                             f"by up to {err}")
    if got != want:
        raise AssertionError(f"R@K {got} is not the merged matrix's {want}")


@contextlib.contextmanager
def _forced_body(module, body: str):
    """The kernel of ``module`` (fa, mba or fsp) forced to ``body``: for the
    comparisons of its bodies only; nothing else runs forced."""
    real = module._launch
    module._launch = functools.partial(real, body=body)
    try:
        yield
    finally:
        module._launch = real


_attention_body = functools.partial(_forced_body, fa)
_mba_body = functools.partial(_forced_body, mba)
_stem_body = functools.partial(_forced_body, fsp)


def _windows_in_turns(call, force, bodies):
    """Host ms of ``call()``, synchronised, under ``force(body)`` for each
    of two bodies, in windows of 2 * REPEATS calls after a warm call, ABBA
    BAAB: a drift through the windows falls on both bodies alike. Returns
    ({body: [ms, ...]}, each window's body and p50)."""
    a, b = bodies
    ms, windows = {a: [], b: []}, []
    for body in (a, b, b, a, b, a, a, b):
        with force(body):
            call()
            win = []
            for _ in range(2 * REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                win.append((time.perf_counter() - t0) * 1e3)
        ms[body] += win
        windows.append(f"{body} {np.median(win):.2f}")
    return ms, ", ".join(windows)


def _bench_in_turns(what, model, cfg, rng, force, bodies):
    """The bench unit's clips/s at BENCH_UNITS, kernel form, under
    ``force(body)`` for each of two bodies in turns (A, B, B, A)."""
    a, b = bodies
    for nc, bv in BENCH_UNITS:
        ts, batch = _bench_unit(rng, cfg, nc, bv)
        rate = {a: [], b: []}
        for body in (a, b, b, a):
            with force(body):
                t = _time_ms(lambda: steps.mil_forward(
                    model, cfg, ts, batch, torch.bfloat16, use_kernels=True),
                    2)
            rate[body].append(bv * nc / (t / 1e3))
        print(f"{what} end to end, bench unit {bv} videos x {nc} clip(s), "
              "kernel form: " + ", ".join(
                  f"{k} " + " / ".join(f"{r:.1f}" for r in rate[k])
                  + " clips/s" for k in bodies))
        del batch
        torch.cuda.empty_cache()


def _eval_in_turns(what, force, bodies, counter, per_group, run_cfg, cfg,
                   model, tok, path, rows, single):
    """Phase 7's eval under ``force(body)``, in turns (A, B, B, A). Body A,
    the main path's, makes ``per_group`` launches a video group on
    ``_counts()[counter]`` and gives phase 7's matrix bit for bit; body B
    makes none there and stays within PROB_ATOL of it."""
    a, b = bodies
    for body in (a, b, b, a):
        ds = _eval_dataset(rows, tok, path, run_cfg)
        stats = {}
        _reset_counts()
        with force(body):
            t0 = time.perf_counter()
            m = inference_retrieval(run_cfg, cfg, model, ds, torch.bfloat16,
                                    stats)
            wall = time.perf_counter() - t0
        _expect(f"{what}, eval, body {body}, body {a} launches",
                _counts()[counter],
                per_group * stats["n_groups"] if body == a else 0)
        err = float(np.abs(m["score_matrix"] - single).max())
        print(f"{what} end to end, eval, body {body}: wall {wall:.3f} s, "
              f"dispatch_s + fetch_s "
              f"{stats['dispatch_s'] + stats['fetch_s']:.3f} s; matrix vs "
              f"phase 7's max_abs_diff {err:.3e}; stage stats "
              + _stats_json(stats))
        if body == a and not np.array_equal(m["score_matrix"], single):
            raise AssertionError(f"{what}: the {a} eval matrix differs from "
                                 f"phase 7's by {err}")
        if err > PROB_ATOL:
            raise AssertionError(f"{what}: the {body} eval matrix differs "
                                 f"from phase 7's by {err} > {PROB_ATOL}")


def phase_bodies(model, cfg, tok, run_cfg, path, rows, single):
    """Phase 12: the tc and v2 bodies end to end, in turns."""
    rng = np.random.default_rng(12)
    caps = _captions(rng, 32)
    for nc in (1, 16):
        sc = RetrievalScorer(model, cfg, tok, n_clips=nc, device="cuda",
                             compute_dtype=torch.bfloat16, num_frm=2,
                             max_img_size=448, max_txt_len=20,
                             max_captions=32)
        feats = sc.encode_frames(rng.integers(0, 256, (nc * 2, 240, 320, 3),
                                              np.uint8))
        ms, windows = _windows_in_turns(
            lambda: sc.score(None, caps, features=feats), _attention_body,
            ("tc", "v2"))
        print(f"attention bodies end to end, {nc} clip(s) x 32 captions, "
              f"scoring call ({8 * REPEATS} calls each, in turns): p50 tc "
              f"{np.median(ms['tc']):.2f} ms, v2 {np.median(ms['v2']):.2f} "
              f"ms; window p50s {windows} ms")
    n_cap_batches = -(-EVAL_CAPTIONS // run_cfg.inference_batch_size)
    _eval_in_turns("attention bodies", _attention_body, ("tc", "v2"), 3,
                   cfg.num_hidden_layers * n_cap_batches, run_cfg, cfg,
                   model, tok, path, rows, single)


def phase_cnn_bodies(model, cfg, tok, run_cfg, path, rows, single):
    """Phase 13: matmul_bn_act's wgmma body against its mma.sync body
    (forced) end to end, in turns: the 16-clip encode, the bench unit and
    the eval."""
    rng = np.random.default_rng(13)
    sc = RetrievalScorer(model, cfg, tok, n_clips=16, device="cuda",
                         compute_dtype=torch.bfloat16, num_frm=2,
                         max_img_size=448, max_txt_len=20, max_captions=32)
    frames = rng.integers(0, 256, (32, 240, 320, 3), np.uint8)
    ms, windows = _windows_in_turns(lambda: sc.encode_frames(frames),
                                    _mba_body, ("wg", "mma"))
    print(f"matmul_bn_act bodies end to end, 16-clip encode_frames "
          f"({8 * REPEATS} calls each, in turns): p50 wg "
          f"{np.median(ms['wg']):.2f} ms, mma {np.median(ms['mma']):.2f} ms; "
          f"window p50s {windows} ms")
    _bench_in_turns("matmul_bn_act bodies", model, cfg, rng, _mba_body,
                    ("wg", "mma"))
    _eval_in_turns("matmul_bn_act bodies", _mba_body, ("wg", "mma"), 4,
                   MBA_PER_ENCODE, run_cfg, cfg, model, tok, path, rows,
                   single)


def phase_stem_bodies(model, cfg, tok):
    """Phase 14: the stem's tc body against its direct body (forced) end to
    end, in turns: the 16-clip and 1-clip encodes (the grid features of
    the two bodies on the same frames within FEAT_REL) and the bench
    unit."""
    torch.cuda.empty_cache()
    rng = np.random.default_rng(14)
    for nc in (16, 1):
        sc = RetrievalScorer(model, cfg, tok, n_clips=nc, device="cuda",
                             compute_dtype=torch.bfloat16, num_frm=2,
                             max_img_size=448, max_txt_len=20,
                             max_captions=32)
        frames = rng.integers(0, 256, (2 * nc, 240, 320, 3), np.uint8)
        feats = {}
        for body in ("tc", "direct"):
            before = (fsp.LAUNCHES, fsp.TC_LAUNCHES)
            with _stem_body(body):
                feats[body] = sc.encode_frames(frames)
            _expect(f"{nc}-clip encode, stem body {body}, tc launches",
                    fsp.TC_LAUNCHES - before[1], int(body == "tc"))
        gap = _rel_gap(feats["tc"], feats["direct"])
        ms, windows = _windows_in_turns(lambda: sc.encode_frames(frames),
                                        _stem_body, ("tc", "direct"))
        print(f"stem bodies end to end, {nc}-clip encode_frames "
              f"({8 * REPEATS} calls each, in turns): p50 tc "
              f"{np.median(ms['tc']):.2f} ms, direct "
              f"{np.median(ms['direct']):.2f} ms; window p50s {windows} ms; "
              f"grid features tc vs direct: relative gap {gap:.3e} (bound "
              f"{FEAT_REL})")
        if not gap <= FEAT_REL:
            raise AssertionError(f"{nc}-clip encode: the stem's two bodies' "
                                 f"grid features differ by {gap}")
    _bench_in_turns("stem bodies", model, cfg, rng, _stem_body,
                    ("tc", "direct"))


# ---- phase 15: the QA family at full width --------------------------------

QA_VQA_LABELS = 3129     # configs/vqa_base_resnet50.json
QA_OPEN_LABELS = 1500    # the open-ended video-QA tasks' seeded vocabulary
QA_IMAGES = 32
# The joint sequences at each QA config's own width (B, S, H, dh, what):
# S = max_txt_len + (max_img_size / 64)^2 grid tokens. All but MSRVTT-MC
# run past the tensor-core body's S <= 128 (fa.TC_MAX_SEQ), on v2.
QA_ATTN_SHAPES = [
    (32, 20 + 144, 12, 64, "VQA: 32 questions at 768 px, text 20"),
    (32, 25 + 144, 12, 64, "TGIF frameqa: 32 questions at 768 px, text 25"),
    (5, 25 + 144, 12, 64, "TGIF action: 5 options at 768 px, text 25"),
    (256, 100 + 49, 12, 64, "MSRVTT-QA: 8 clips x 32 questions at 448 px, "
     "text 100"),
    (16 * 5 * 16, 20 + 49, 12, 64, "MSRVTT-MC eval batch: 16 videos x 5 "
     "options x 16 clips")]
QA_STEM_FRAMES = (1, 32)             # frames of 768^2
# (scorer, model, task, scorer settings): each config's resolution, text
# length, frames and clips (configs/*_base_resnet50.json)
QA_SCORERS = (
    ("VQA", "vqa", "vqa", dict(max_img_size=768, max_txt_len=20)),
    ("TGIF frameqa", "open", "frameqa",
     dict(num_frm=1, n_clips=1, fps=1, max_img_size=768, max_txt_len=25,
          score_agg_func="mean")),
    ("TGIF action", "mc", "action",
     dict(num_frm=1, n_clips=1, fps=1, max_img_size=768, max_txt_len=25,
          score_agg_func="mean")),
    ("MSRVTT-QA", "open", "msrvtt_qa",
     dict(num_frm=2, n_clips=8, fps=2, max_img_size=448, max_txt_len=100,
          score_agg_func="lse")))


def _qa_models(cfg):
    """{name: (model, config)}: one seeded full-width model per QA head,
    frozen BN folded: VQA's seq_cls over 3129 answers (bce), the open
    video-QA seq_cls over 1500 (ce) and the multiple-choice head."""
    out = {}
    for name, head, n, loss, seed in (
            ("vqa", "seq_cls", QA_VQA_LABELS, "bce", 15),
            ("open", "seq_cls", QA_OPEN_LABELS, "ce", 16),
            ("mc", "multi_choice", 5, "ce", 17)):
        mcfg = cfg.replace(num_labels=n, loss_type=loss)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = clipbert.init_clipbert(mcfg, head, generator=gen,
                                       device="cuda")
        clipbert.fold_cnn_bn_scales(model)
        out[name] = (model.eval().requires_grad_(False), mcfg)
    return out


def _seq_len(txt_len, img):
    return txt_len + (img // 64) ** 2


def _attn_body(S):
    return fa._plan(1, S, 12, 64, torch.bfloat16, True).body


def _expect_qa(what, d, S, calls, encodes):
    """Launch deltas of ``calls`` scoring calls at joint length S and
    ``encodes`` CNN encodes: 12 attention launches a call on the body
    _plan names, 36 fused 1x1 convs on wg and one stem on tc an encode."""
    body = _attn_body(S)
    _expect(f"{what}, attention", d[0], 12 * calls)
    _expect(f"{what}, attention on the tensor-core body", d[3],
            12 * calls if body == "tc" else 0)
    _expect(f"{what}, matmul_bn_act", d[1], MBA_PER_ENCODE * encodes)
    _expect(f"{what}, matmul_bn_act on the wgmma body", d[4],
            MBA_PER_ENCODE * encodes)
    _expect(f"{what}, fused_stem_pool", d[2], encodes)
    _expect(f"{what}, fused_stem_pool on the tensor-core body", d[5],
            encodes)
    return body


def phase_qa_kernels(gen):
    """Phase 15, the kernels at the QA family's shapes: each against its
    plain version, then timed in turns as graph replays beside the library
    call and the bound. Returns ({kernel: {shape: timing}}, the worst bf16
    error of each)."""
    times = {"fused_attention": {}, "matmul_bn_act": {},
             "fused_stem_pool": {}}
    err = dict.fromkeys(times, 0.0)
    for B, S, H, dh, what in QA_ATTN_SHAPES:
        err["fused_attention"] = max(err["fused_attention"], _attention_check(
            B, S, H, dh, what, torch.bfloat16, "merged-qkv views", gen))
        times["fused_attention"][str((B, S, H, dh))] = dict(
            _time_attention(B, S, H, dh, what, gen), body=_attn_body(S),
            launches_per_call=12)
    for B in QA_STEM_FRAMES:
        e, body = _stem_check(B, 768, 768, torch.bfloat16, gen)
        if body != "tc":
            raise AssertionError(f"bf16 stem {(B, 768, 768)} ran {body}")
        err["fused_stem_pool"] = max(err["fused_stem_pool"], e)
        times["fused_stem_pool"][str((B, 768, 768))] = dict(
            _time_stem(B, 768, 768, gen, earlier=False), launches_per_call=1)
    launches = _r50_1x1_launches(1, 768)
    per = {}
    for shape, n in launches.items():
        e, body = _mba_check(*shape, torch.bfloat16, gen)
        if body != "wg":
            raise AssertionError(f"R50 shape {shape} at 768 px ran {body}")
        err["matmul_bn_act"] = max(err["matmul_bn_act"], e)
        per[shape] = _time_mba(shape, n, gen, variants=False)
    sums = _mba_sums(launches, per, "one 768 px frame's encode")
    times["matmul_bn_act"]["36-launch sum, 1 x 768^2"] = {
        "ms": sums["kernel"], "plain_ms": sum(
            n * per[s]["plain_ms"] for s, n in launches.items()),
        "library_ms": sums["library"], "bound_ms": sums["bound"],
        "launches_per_call": MBA_PER_ENCODE}
    return times, err


def _jpeg(rng, h, w):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _qa_request(sc, task, frames, qs, n):
    """One request (encode + one scoring call) on scorer ``sc``; returns
    (encode s, request s, probabilities)."""
    t0 = time.perf_counter()
    feats = (sc.encode_image(frames) if task == "vqa"
             else sc.encode_frames(frames))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if task == "action":
        probs = sc.answer_mc(None, qs[0], qs[1:6], features=feats)
    else:
        probs = sc.probs(None, qs[:n], features=feats)
    return t1 - t0, time.perf_counter() - t0, probs


def phase_qa_scorers(models, tok):
    """Phase 15, the scorers at each config's width: VQAScorer on one
    480x640 JPEG at 768 px with 1, 5 and 32 questions; VideoQAScorer on
    frameqa and action (1 clip x 1 frame at 768 px, text 25) and
    msrvtt_qa (8 clips x 2 frames at 448 px, text 100). Counts from 0 per
    request; the kernel form against the cuDNN + einsum form. Returns the
    launches of the main path."""
    rng = np.random.default_rng(15)
    qs = _captions(rng, 33)
    launches = [0] * 6
    for what, key, task, kw in QA_SCORERS:
        model, mcfg = models[key]
        S = _seq_len(kw["max_txt_len"], kw["max_img_size"])
        forms = {}
        for form in ("kernels", "cudnn"):
            fk = dict(device="cuda", compute_dtype=torch.bfloat16,
                      use_kernels=form == "kernels",
                      fused_attn=None if form == "kernels" else False)
            if task == "vqa":
                forms[form] = VQAScorer(
                    model, mcfg, tok, {i: f"ans{i}" for i in
                                       range(QA_VQA_LABELS)},
                    max_questions=32, **kw, **fk)
            else:
                forms[form] = VideoQAScorer(
                    model, mcfg, tok, task, max_questions=32,
                    label2ans={i: f"ans{i}" for i in range(QA_OPEN_LABELS)},
                    **kw, **fk)
        if task == "vqa":
            frames = _jpeg(rng, 480, 640)
        else:
            frames = rng.integers(0, 256, (kw["n_clips"] * kw["num_frm"],
                                           240, 320, 3), np.uint8)
        t0 = time.perf_counter()
        for sc in forms.values():
            sc.warmup(((480, 640),) if task == "vqa" else ((240, 320),))
        torch.cuda.synchronize()
        print(f"{what}: warmup of both forms {time.perf_counter() - t0:.2f}"
              " s")
        sizes = (5,) if task == "action" else REQUEST_SIZES

        # ---- the main path: counts from 0, read right after ----------
        _reset_counts()
        enc, req = [], {n: [] for n in sizes}
        for _ in range(REPEATS):
            for n in sizes:
                before = _counts()
                te, tr, probs = _qa_request(forms["kernels"], task, frames,
                                            qs, n)
                enc.append(te)
                req[n].append(tr)
                d = [a - b for a, b in zip(_counts(), before)]
                body = _expect_qa(f"{what} request", d, S, 1, 1)
                want = ((5,) if task == "action" else
                        (n, QA_VQA_LABELS if task == "vqa"
                         else QA_OPEN_LABELS))
                if probs.shape != want or not np.isfinite(probs).all() or \
                        not ((probs >= 0) & (probs <= 1)).all():
                    raise AssertionError(f"{what}: bad probabilities "
                                         f"{probs.shape}")
        got = _counts()
        launches = [a + b for a, b in zip(launches, got)]
        print(f"{what} (S = {S}, attention body {body}): "
              f"{REPEATS * len(sizes)} requests launched attention "
              f"{got[0]} ({got[3]} on tc), matmul_bn_act {got[1]} ({got[4]} "
              f"on wg), fused_stem_pool {got[2]} ({got[5]} on tc) times; "
              f"p50 encode {np.median(enc) * 1e3:.2f} ms, p50 request "
              + ", ".join(f"{n} question(s) {np.median(req[n]) * 1e3:.2f} ms"
                          for n in sizes))

        # ---- the kernel form against the cuDNN + einsum form -------------
        probs = {f: _qa_request(sc, task, frames, qs, 5)[2]
                 for f, sc in forms.items()}
        err = float(np.abs(probs["kernels"] - probs["cudnn"]).max())
        print(f"{what}, 5 questions: probabilities, kernel form vs cuDNN + "
              f"einsum form: max_abs_diff {err:.3e} (PROB_ATOL {PROB_ATOL})")
        if err > PROB_ATOL:
            raise AssertionError(f"{what}: the forms' probabilities differ "
                                 f"by {err} > {PROB_ATOL}")

        def encode(form, sc=forms, task=task, frames=frames):
            return (sc[form].encode_image(frames) if task == "vqa"
                    else sc[form].encode_frames(frames))

        def score(feats, sc=forms["kernels"], task=task):
            if task == "action":
                return sc.answer_mc(None, qs[0], qs[1:6], features=feats)
            return sc.probs(None, qs[:5], features=feats)

        if kw["max_img_size"] == 768:
            _check_cnn_forms(f"{what} at 768 px", model, encode, score)
        else:
            gap = _rel_gap(encode("kernels"), encode("cudnn"))
            print(f"{what}: grid features, kernel form vs cuDNN form: "
                  f"relative gap {gap:.3e} (bound {FEAT_REL})")
            if not gap <= FEAT_REL:
                raise AssertionError(f"{what}: the CNN's forms' grid "
                                     f"features differ by {gap}")
        del forms
        torch.cuda.empty_cache()
    return launches


def _qa_annotations(d, rng, vid_ids):
    """Seeded annotations for the runners: TGIF action and frameqa on the
    videos, VQA on QA_IMAGES images, MSRVTT-MC on the videos."""
    types = ["object", "number", "color", "location"]
    vqa_types = ["yes/no", "number", "other"]
    ann = {
        "action": [{"vid_id": v, "question": _captions(rng, 1)[0],
                    "question_id": 1000 + i, "answer": int(rng.integers(5)),
                    "options": _captions(rng, 5)}
                   for i, v in enumerate(vid_ids)],
        "frameqa": [{"vid_id": v, "question": _captions(rng, 1)[0],
                     "question_id": 2000 + i,
                     "answer": f"ans{rng.integers(QA_OPEN_LABELS)}",
                     "answer_type": types[i % 4]}
                    for i, v in enumerate(vid_ids)],
        "vqa": [{"question_id": 3000 + i, "txt": _captions(rng, 1)[0],
                 "img_id": f"image{i}",
                 "labels": {f"ans{rng.integers(QA_VQA_LABELS)}": 1.0,
                            f"ans{rng.integers(QA_VQA_LABELS)}": 0.3},
                 "answer_type": vqa_types[i % 3]}
                for i in range(QA_IMAGES)],
        "mc": [{"id": i, "vid_id": v, "answer": int(rng.integers(5)),
                "options": _captions(rng, 5)}
               for i, v in enumerate(vid_ids)]}
    paths = {}
    for name, rows in ann.items():
        paths[name] = os.path.join(d, f"qa_{name}.jsonl")
        with open(paths[name], "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return paths


def _decisions(task, logits):
    """(predictions, the gap between each item's top two) of a run's
    concatenated eval logits, as its runner decides: the argmax logit, or
    for MSRVTT-MC the option of highest positive probability."""
    x = logits.astype(np.float64)
    if task == "mc":
        e = np.exp(x - x.max(-1, keepdims=True))
        x = (e / e.sum(-1, keepdims=True))[:, 1].reshape(-1, 5)
    top2 = np.sort(x, axis=-1)[:, -2:]
    return x.argmax(-1), top2[:, 1] - top2[:, 0]


def phase_qa_runners(models, model, model_cfg, tok, d, path):
    """Phase 15, the runners' own eval loops with the seeded models:
    run_video_qa.build_validate (action, frameqa) and
    run_msrvtt_mc.inference_mc (16 clips) on phase 7's 16 videos, and
    run_vqa.build_validate on QA_IMAGES seeded 480x640 JPEGs. After a warm
    run, each runs with make_eval_step's fused core and its einsum core in
    turns (k, e, e, k), then in the cuDNN + einsum form, whose predictions
    must equal the kernel form's except where an item's top two lie
    within PROB_ATOL. Returns the launches of the main path (the first
    timed k run)."""
    rng = np.random.default_rng(16)
    img_path = os.path.join(d, "images.cbpk")
    with store.PackWriter(img_path) as w:
        for i in range(QA_IMAGES):
            w.put(f"image{i}", _jpeg(rng, 480, 640))
    ann = _qa_annotations(d, rng, [f"video{i}" for i in range(EVAL_VIDEOS)])
    ans2label = {f"ans{i}": i for i in range(QA_OPEN_LABELS)}
    vqa_a2l = {f"ans{i}": i for i in range(QA_VQA_LABELS)}
    launches = [0] * 6
    for task, config in (("action", "tgif_qa_action"),
                         ("frameqa", "tgif_qa_frameqa"),
                         ("vqa", "vqa"), ("mc", "msrvtt_ret")):
        cfg = load_run_config(["--config", os.path.join(
            ROOT, "configs", f"{config}_base_resnet50.json")])
        if task == "mc":
            cfg.num_labels = 2
            net, mcfg = model, model_cfg
        elif task == "vqa":
            cfg.num_labels = QA_VQA_LABELS
            net, mcfg = models["vqa"]
        else:
            cfg = run_video_qa.derive_task_attrs(
                cfg, ans2label if task == "frameqa" else None)
            net, mcfg = models["mc" if task == "action" else "open"]
        st = store.open_store(img_path if task == "vqa" else path)
        if task == "vqa":
            groups = run_vqa.build_datalist([ann["vqa"]], 1.0, False, 1)
            ds = VQADataset(groups, tok, st, ans2label=vqa_a2l,
                            max_img_size=cfg.max_img_size,
                            max_txt_len=cfg.max_txt_len,
                            device_preprocess=cfg.device_preprocess)
            ts = run_vqa.make_task_settings(cfg, is_train=False)
            coll = RetrievalCollator(tok, cfg.max_txt_len)
        elif task == "mc":
            ds = MSRVTTMCEvalDataset(
                load_jsonl(ann["mc"]), tok, st,
                fps=cfg.fps, num_frm=cfg.num_frm,
                max_img_size=cfg.max_img_size, max_txt_len=cfg.max_txt_len,
                ensemble_n_clips=cfg.inference_n_clips,
                device_preprocess=cfg.device_preprocess)
            ts = steps.TaskSettings(
                head_type="retrieval", num_labels=2, loss_type=cfg.loss_type,
                score_agg_func=cfg.score_agg_func,
                train_n_clips=cfg.inference_n_clips,
                group_size=run_msrvtt_mc.N_OPTIONS)
        else:
            ds = run_video_qa.build_dataset(
                cfg, run_video_qa.build_groups(cfg, ann[task], False), tok,
                st, ans2label if task == "frameqa" else None, False,
                cfg.inference_n_clips)
            ts = run_video_qa.make_task_settings(cfg, cfg.inference_n_clips)
            coll = VideoQACollator(tok, cfg.max_txt_len)
        if task != "mc":
            dl = common.build_eval_loader(ds, coll, cfg,
                                          cfg.inference_batch_size)
            validate = (run_vqa if task == "vqa" else run_video_qa
                        ).build_validate(cfg, ds, dl, torch.bfloat16)
        S = _seq_len(cfg.max_txt_len, cfg.max_img_size)
        n_items = len(ds)
        n_batches = -(-n_items // cfg.inference_batch_size)

        def run(form):
            kept = []
            step = steps.make_eval_step(
                mcfg, ts, torch.bfloat16,
                fused_attn=None if form == "k" else False,
                use_kernels=form != "r")

            def eval_fn(m, batch):
                out = step(m, batch)
                kept.append(out["logits"])
                return out

            t0 = time.perf_counter()
            if task == "mc":
                m = run_msrvtt_mc.inference_mc(cfg, mcfg, net, ds,
                                               torch.bfloat16, eval_fn)
            else:
                m = validate(net, eval_fn)
            wall = time.perf_counter() - t0
            return m, torch.cat(kept).float().cpu().numpy(), wall

        run("k")        # warm: cuDNN's algorithm choice at these shapes
        walls = {"k": [], "e": []}
        runs = {}
        for i, form in enumerate(("k", "e", "e", "k", "r")):
            if i == 0:
                # ---- the main path: counts from 0, read right after ----
                _reset_counts()
            before = _counts()
            runs[form] = run(form)
            delta = [a - b for a, b in zip(_counts(), before)]
            if i == 0:
                _expect_qa(f"{task} eval", delta, S, n_batches, n_batches)
                launches = [a + b for a, b in zip(launches, delta)]
            elif form == "e":
                _expect(f"{task} eval, einsum core, attention", delta[0], 0)
                _expect(f"{task} eval, einsum core, matmul_bn_act", delta[1],
                        MBA_PER_ENCODE * n_batches)
            elif form == "r":
                _expect(f"{task} eval, cuDNN + einsum form", sum(delta), 0)
            if form in walls:
                walls[form].append(runs[form][2])
        metrics = {k: v for k, v in runs["k"][0].items()
                   if k not in ("results", "preds")}
        pk, gap = _decisions(task, runs["k"][1])
        pr, _ = _decisions(task, runs["r"][1])
        differ = np.flatnonzero(pk != pr)
        near = int((gap <= PROB_ATOL).sum())
        print(f"{task} eval ({n_items} items, {n_batches} batch(es), S = {S}, "
              f"attention body {_attn_body(S)}): metrics {json.dumps(metrics)}"
              f"; eval wall in turns, fused core "
              + " / ".join(f"{t:.3f}" for t in walls["k"]) + " s, einsum core "
              + " / ".join(f"{t:.3f}" for t in walls["e"]) + " s, cuDNN + "
              f"einsum form {runs['r'][2]:.3f} s; predictions kernel form vs "
              f"cuDNN + einsum form: {len(differ)} differ, {near} items with "
              f"their top two within PROB_ATOL; logits max_abs_diff "
              f"{np.abs(runs['k'][1] - runs['r'][1]).max():.3e}")
        if (gap[differ] > PROB_ATOL).any():
            raise AssertionError(f"{task} eval: predictions {differ} differ "
                                 f"between the forms with top-two gaps "
                                 f"{gap[differ]} > {PROB_ATOL}")
        answered = runs["k"][0]["preds" if task == "mc" else "results"]
        if len(answered) != n_items:
            raise AssertionError(f"{task} eval: {len(answered)} of "
                                 f"{n_items} items answered")
        if ds.n_fallbacks:
            raise AssertionError(f"{task} eval: {ds.n_fallbacks} visuals did "
                                 f"not decode")
    return launches


# ---------------------------------------------------------------------------
# phase 16: MSRVTT retrieval training
# ---------------------------------------------------------------------------

# 16a: one train step on the card against the CPU, fp32 with TF32 off, at a
# small width over the full ResNet-50. Tolerances fixed before the first
# run: the loss and grad norm within TRAIN_LOSS_RTOL; each gradient within
# a share of its leaf's largest |element|: the transformer's TRAIN_BERT_REL
# (fp32 sums in other orders: cuBLAS against oneDNN), the CNN's
# TRAIN_CNN_REL (53 convs whose ReLU masks flip where a pre-activation sits
# within rounding of 0: two CPU runs of the port, on other thread counts,
# differ by percents; tests/test_torch_train_step.py). A leaf's scale is floored at
# TRAIN_GRAD_FLOOR of the global gradient norm: the key biases' gradient is
# 0 in exact arithmetic (softmax ignores a bias shared by all keys), so
# both sides hold rounding noise there.
TRAIN_CHECK_KW = dict(hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=256,
                      max_position_embeddings=64,
                      max_grid_row_position_embeddings=8,
                      max_grid_col_position_embeddings=8, num_labels=2,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_FLOOR = 1e-6
TRAIN_BERT_REL = 1e-3
TRAIN_CNN_REL = 5e-2
# the bf16 product's backward (ops/linear.py::_ProductF32) against fp32
# autograd on the same bf16 operands: the cotangent rounds to bf16 (2**-9
# relative) and each gradient once more to bf16 (2**-9)
DENSE_BF16_REL = 1e-2
# 16b: the config's batch for a few steps, validation at the last one
TRAIN_STEPS = 4
# 16c: 20 steps on one repeated batch (_learn_batch) from the seeded init
# at a constant lr; the mean of the last 3 losses must sit LEARN_MARGIN
# below the first. At lr 3e-5 and above the loss oscillated about chance
# for 20 steps; at 1e-5 it fell steadily, by 0.029 (PERF.md §6): the
# margin is a third of that. The first 3 steps warm up; the other 17 are
# timed.
LEARN_STEPS, LEARN_WARM, LEARN_LR, LEARN_MARGIN = 20, 3, 1e-5, 0.01


def _tree_gap(name, got, want, rel, floor):
    """max |got - want| / max(max |want|, floor) over one gradient,
    checked against ``rel``."""
    scale = max(float(want.abs().max()), floor)
    gap = float((got - want).abs().max())
    if gap > rel * max(scale, 1e-30):
        raise AssertionError(f"{name}: gradient gap {gap:.3e} > {rel} x "
                             f"{scale:.3e}")
    return gap / scale


def _train_grads(model, cfg, ts, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = steps.compute_loss(model, cfg, ts, batch, 0, True,
                                 torch.float32)
    loss.backward()
    grads = {n: p.grad.detach().float().cpu() for n, p in
             model.named_parameters() if p.grad is not None}
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))
    return float(loss.detach()), norm, grads


def phase_train_autograd(tok):
    """16a: the train step's autograd on the card (cuDNN, cuBLAS) against
    the CPU path, which the CPU tests hold to JAX."""
    import copy
    from clipbert_tpu_torch.ops.linear import dense
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(vocab_size=len(tok), **TRAIN_CHECK_KW)
    ts = steps.TaskSettings(head_type="retrieval", score_agg_func="lse",
                            train_n_clips=2, group_size=2)
    cpu_model = clipbert.init_clipbert(
        cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(7)
    ids = rng.integers(1, len(tok), (4, 12))
    mask = np.ones_like(ids)
    mask[:, 9:] = 0
    host = {"visual_inputs": (rng.standard_normal((2, 2, 64, 64, 3))
                              * 50).astype(np.float32),
            "text_input_ids": ids, "text_input_mask": mask,
            "labels": np.array([1, 0, 1, 0])}
    _reset_counts()
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        out[dev] = _train_grads(model, cfg, ts, batch)
    _expect("16a train step, kernels", sum(_counts()), 0)
    (lg, ng, gg), (lc, nc_, gc) = out["cuda"], out["cpu"]
    for what, a, b in (("loss", lg, lc), ("grad norm", ng, nc_)):
        if abs(a - b) > TRAIN_LOSS_RTOL * abs(b):
            raise AssertionError(f"16a {what}: card {a} vs CPU {b}")
    if gg.keys() != gc.keys():
        raise AssertionError("16a: the card and the CPU have gradients for "
                             "different parameters")
    worst = {"cnn": 0.0, "transformer": 0.0}
    for n in gc:
        part = "cnn" if n.startswith("cnn.") else "transformer"
        worst[part] = max(worst[part], _tree_gap(
            n, gg[n], gc[n],
            TRAIN_CNN_REL if part == "cnn" else TRAIN_BERT_REL,
            TRAIN_GRAD_FLOOR * nc_))
    # the bf16 product's custom backward, as the full-width step runs it
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(512, 768, device="cuda", generator=g).bfloat16()
    w = torch.randn(3072, 768, device="cuda", generator=g).bfloat16()
    b = torch.randn(3072, device="cuda", generator=g)
    dy = torch.randn(512, 3072, device="cuda", generator=g)
    grads = []
    for xx, ww in ((x, w), (x.float(), w.float())):
        xx, ww, bb = (t.detach().requires_grad_() for t in (xx, ww, b))
        y = dense(xx, ww, bb)
        (y.float() * dy).sum().backward()
        grads.append((xx.grad.float(), ww.grad.float(), bb.grad.float()))
    dense_rel = max(float((a - r).abs().max() / r.abs().max())
                    for a, r in zip(*grads))
    if dense_rel > DENSE_BF16_REL:
        raise AssertionError(f"bf16 dense backward: {dense_rel} > "
                             f"{DENSE_BF16_REL}")
    print(f"16a train step, card vs CPU (fp32, TF32 off, {len(gc)} "
          f"gradients, hidden 128 over the full ResNet-50 at 64^2): loss "
          f"{lg:.7f} vs {lc:.7f}, grad norm {ng:.7e} vs {nc_:.7e}; worst "
          f"gradient gap / leaf max: transformer {worst['transformer']:.3e} "
          f"(bound {TRAIN_BERT_REL}), CNN {worst['cnn']:.3e} (bound "
          f"{TRAIN_CNN_REL}); bf16 dense backward vs fp32 autograd "
          f"{dense_rel:.3e} (bound {DENSE_BF16_REL}); 0 kernel launches")


def _train_cfg(d, path, rows):
    """The MSRVTT retrieval config with its batch (16 videos x 8 clips x
    2 frames at 448^2, 1 positive + 1 negative caption a video, bf16),
    the seeded init (no reference .pt), phase 7's store: one train caption
    per video and the 72 captions to validate on."""
    with open(os.path.join(ROOT, "configs",
                           "msrvtt_ret_base_resnet50.json")) as f:
        base = json.load(f)
    train_txt = os.path.join(d, "train.jsonl")
    val_txt = os.path.join(d, "val.jsonl")
    with open(train_txt, "w") as f:
        for r in rows[:EVAL_VIDEOS]:
            f.write(json.dumps({"vid_id": r["vid_id"], "txt": r["txt"]})
                    + "\n")
    with open(val_txt, "w") as f:
        for r in rows:
            f.write(json.dumps({"vid_id": r["vid_id"], "txt": r["txt"]})
                    + "\n")
    base.update(
        model_config=os.path.join(ROOT, base["model_config"]),
        tokenizer_dir=d, e2e_weights_path=None,
        train_datasets=[{"name": "msrvtt", "txt": train_txt, "img": path}],
        val_datasets=[{"name": "msrvtt", "txt": val_txt, "img": path}],
        output_dir=os.path.join(d, "train_out"),
        num_train_epochs=TRAIN_STEPS * base["train_batch_size"]
        // EVAL_VIDEOS, num_valid=1, min_valid_steps=TRAIN_STEPS,
        save_steps_ratio=0.5, inference_video_batch_size=8, device="cuda")
    cfg_path = os.path.join(d, "train_run.json")
    with open(cfg_path, "w") as f:
        json.dump(base, f)
    return load_run_config(["--config", cfg_path])


def phase_train(tok, d, path, rows):
    """16b and 16c. Returns the validation's launches (attention,
    matmul_bn_act, fused_stem_pool)."""
    from clipbert_tpu_torch.ckpt.from_jax import model_state, to_jax_flat
    from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
    from clipbert_tpu_torch.train import optim, trainer
    t16 = time.perf_counter()
    cfg = _train_cfg(d, path, rows)
    steps_rec, val_rec = [], []
    real_step, real_val = steps.make_train_step, rvr.inference_retrieval

    def recording_step(*a, **k):
        step = real_step(*a, **k)

        def run(state, batch, seed):
            before = _counts()
            state, m = step(state, batch, seed)
            steps_rec.append((m, [x - y for x, y in zip(_counts(), before)],
                              batch))
            return state, m
        return run

    def recording_val(*a, **k):
        before = _counts()
        stats = {}
        t0 = time.perf_counter()
        out = real_val(*a, stage_stats=stats, **k)
        val_rec.append((out, [x - y for x, y in zip(_counts(), before)],
                        time.perf_counter() - t0, stats, before))
        return out

    # ---- the main path: counts from 0, read right after ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps.make_train_step, rvr.inference_retrieval = (recording_step,
                                                      recording_val)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        res = rvr.start_training(cfg)
    finally:
        steps.make_train_step, rvr.inference_retrieval = real_step, real_val
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = _counts()
    peak = torch.cuda.max_memory_allocated()
    model_cfg = inject_task_attrs(ModelConfig.from_json(cfg.model_config),
                                  cfg)

    # every step finite, positive, no kernel launched
    if res["global_step"] != TRAIN_STEPS or len(steps_rec) != TRAIN_STEPS:
        raise AssertionError(f"trained {res['global_step']} steps, "
                             f"expected {TRAIN_STEPS}")
    losses = [float(m["loss"]) for m, _, _ in steps_rec]
    norms = [float(m["grad_norm"]) for m, _, _ in steps_rec]
    for i, (m, launched, _) in enumerate(steps_rec):
        _expect(f"train step {i + 1}, kernels", sum(launched), 0)
    if not all(np.isfinite(losses + norms)) or min(losses + norms) <= 0:
        raise AssertionError(f"losses {losses} grad norms {norms}")
    # validation: once, at the last step, every kernel on its body
    if len(val_rec) != 1:
        raise AssertionError(f"{len(val_rec)} validations, expected 1")
    val, vl, val_wall, stats, before = val_rec[0]
    _expect("kernels before the validation", sum(before), 0)
    g = stats["n_groups"]
    n_cap = -(-EVAL_CAPTIONS // cfg.inference_batch_size)
    _expect("validation, attention", vl[0],
            model_cfg.num_hidden_layers * g * n_cap)
    _expect("validation, attention on the tensor-core body", vl[3], vl[0])
    _expect("validation, matmul_bn_act", vl[1], MBA_PER_ENCODE * g)
    _expect("validation, matmul_bn_act on the wgmma body", vl[4], vl[1])
    _expect("validation, fused_stem_pool", vl[2], g)
    _expect("validation, fused_stem_pool on the tensor-core body", vl[5],
            vl[2])
    if list(total) != vl:
        raise AssertionError(f"launches {total} outside the validation's "
                             f"{vl}")
    _check_matrix(val["score_matrix"])
    # frozen BN bit-unchanged, every trainable parameter moved
    model = res["model"]
    init = trainer.setup_model(cfg, model_cfg, "retrieval", "cuda")
    before_state, after = model_state(init), model_state(model)
    n_bn = n_moved = 0
    still = []
    for n, t in after.items():
        if ".bn." in n and n.startswith("cnn."):
            n_bn += 1
            if not torch.equal(t, before_state[n]):
                raise AssertionError(f"frozen BN {n} changed")
        elif torch.equal(t, before_state[n]):
            if bool(res["state"].opt.mu[n].any()):
                raise AssertionError(f"{n} had gradients and did not move")
            still.append(n)
        else:
            n_moved += 1
    del init
    # the validated matrix against the cuDNN + einsum form on the same
    # trained weights
    val_ds = rvr.build_val_dataset(cfg, tok)
    ref = rvr.inference_retrieval(cfg, model_cfg, model, val_ds,
                                  torch.bfloat16, use_kernels=False,
                                  fused_attn=False)
    err = float(np.abs(ref["score_matrix"] - val["score_matrix"]).max())
    if err > PROB_ATOL:
        raise AssertionError(f"validation matrices: kernel form vs cuDNN + "
                             f"einsum form {err} > {PROB_ATOL}")
    out = cfg.output_dir
    saved = checkpoint.ModelSaver(out).available_steps()
    if saved != [TRAIN_STEPS] or not os.path.exists(
            os.path.join(out, "restore.npz")):
        raise AssertionError(f"checkpoints {os.listdir(out)}")
    logs = os.listdir(os.path.join(out, "log"))
    if not any(f.startswith("events.out") or f == "scalars.jsonl"
               for f in logs):
        raise AssertionError(f"no scalar log in {logs}")
    # a second run on the same output_dir resumes at the saved step
    bundle = checkpoint.load_tree(os.path.join(out, "restore.npz"))
    res2 = rvr.start_training(_train_cfg(d, path, rows))
    resumed = to_jax_flat(model_state(res2["model"]))
    final = to_jax_flat(after)
    want = checkpoint.flatten_tree(bundle["state"]["params"])
    if res2["global_step"] != TRAIN_STEPS or int(bundle["global_step"]) \
            != TRAIN_STEPS or res2["state"].opt.step != TRAIN_STEPS:
        raise AssertionError("resume did not start at the saved step")
    for k in final:
        if not (np.array_equal(resumed[k], want[k])
                and np.array_equal(final[k], want[k])):
            raise AssertionError(f"resumed {k} differs from the bundle")
    del res2, resumed, bundle, want
    print(f"16b training at full width ({cfg.train_batch_size} videos x "
          f"{cfg.train_n_clips} clips x {cfg.num_frm} frames at "
          f"{cfg.max_img_size}^2, {1 + cfg.itm_neg_size} captions a video, "
          f"bf16, remat {cfg.remat}): {TRAIN_STEPS} steps + validation in "
          f"{wall:.2f} s; losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{x:.4f}" for x in norms)
          + f"; 0 kernel launches in the train steps; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"16b validation (inference_retrieval on the live weights, "
          f"{g} video groups x {n_cap} caption minibatches): wall "
          f"{val_wall:.3f} s; attention {vl[0]} ({vl[3]} tc), matmul_bn_act "
          f"{vl[1]} ({vl[4]} wg), fused_stem_pool {vl[2]} ({vl[5]} tc); "
          f"stage stats {_stats_json(stats)}; R@1 t2v {val['t2v_r1']}; "
          f"vs the cuDNN + einsum form max_abs_diff {err:.3e} (bound "
          f"{PROB_ATOL})")
    print(f"16b weights: {n_bn} frozen BN buffers bit-unchanged, {n_moved} "
          f"trainable parameters moved, unmoved with no gradient ever: "
          f"{still}; model_step_{TRAIN_STEPS}.npz and restore.npz written; "
          f"the second run resumed at step {TRAIN_STEPS}, bit-equal to the "
          f"bundle")

    # ---- 16c: learning on one repeated batch, timed with CUDA events ----
    batch = _learn_batch(steps_rec[0][2], tok, rows, cfg)
    del steps_rec[:], val_rec[:], model, res
    torch.cuda.empty_cache()
    ts = rvr.make_task_settings(cfg)
    state, step = _learn_setup(cfg, model_cfg, ts)
    events, metrics = [], []
    _reset_counts()
    for i in range(LEARN_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, m = step(state, batch, 1000 + i)
        e1.record()
        events.append((e0, e1))
        metrics.append(m)
    torch.cuda.synchronize()
    _expect("16c train steps, kernels", sum(_counts()), 0)
    ms = [a.elapsed_time(b) for a, b in events[LEARN_WARM:]]
    losses = [float(m["loss"]) for m in metrics]
    last = float(np.mean(losses[-3:]))
    clips = cfg.train_batch_size * cfg.train_n_clips
    med = float(np.median(ms))
    print(f"16c {LEARN_STEPS} steps on one repeated batch at constant lr "
          f"{LEARN_LR}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; mean of the last 3 {last:.4f} vs first {losses[0]:.4f} "
          f"(must fall by {LEARN_MARGIN})")
    if not last < losses[0] - LEARN_MARGIN:
        raise AssertionError(f"the loss did not fall: {losses}")
    print(f"16 train step at full width (CUDA events, median of {len(ms)} "
          f"after {LEARN_WARM} warm-up): {med:.2f} ms (min {min(ms):.2f}, "
          f"max {max(ms):.2f}); {clips / (med / 1e3):.1f} train clips/s "
          f"({clips} clips a step); peak memory {peak / 2**30:.2f} GiB; "
          f"validation wall {val_wall:.3f} s; card "
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip())
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")
    del state, step, batch, metrics
    torch.cuda.empty_cache()
    return vl[:3]


def _learn_batch(batch, tok, rows, cfg):
    """16b's first batch (each video's caption, then a negative), its
    negatives swapped for captions 16.. of phase 7's rows: captions no
    positive of the batch shares, each paired with a video it does not
    describe. In 16b's batch every negative is another video's positive,
    so one repeated batch holds each text under both labels."""
    ids, mask = batch["text_input_ids"].clone(), \
        batch["text_input_mask"].clone()
    n = ids.shape[0] // 2
    vids = [r["vid_id"] for r in rows]
    negs = [r["txt"] for r in rows[EVAL_VIDEOS:]]
    enc = tok.batch_encode(negs, cfg.max_txt_len)
    labels = batch["labels"].cpu().numpy()
    for k in range(n):
        # the batch's order is the sampler's: find this pair's video by
        # its positive caption, then a caption of another video
        pos = ids[2 * k].tolist()
        v = next(i for i in range(EVAL_VIDEOS) if tok.batch_encode(
            [rows[i]["txt"]], cfg.max_txt_len)["input_ids"][0].tolist()
            == pos)
        j = next(j for j in range(k, len(negs))
                 if vids[EVAL_VIDEOS + j] != vids[v])
        ids[2 * k + 1] = torch.from_numpy(enc["input_ids"][j])
        mask[2 * k + 1] = torch.from_numpy(enc["attention_mask"][j])
    if not (labels[0::2] == 1).all() or (labels[1::2] != 0).any():
        raise AssertionError(f"labels {labels}: not (positive, negative) "
                             "pairs")
    return dict(batch, text_input_ids=ids, text_input_mask=mask)


def _learn_setup(cfg, model_cfg, ts, lr=LEARN_LR):
    """A fresh seeded model (the init 16b started from), a fresh AdamW
    and a constant lr: (state, step)."""
    from clipbert_tpu_torch.train import optim, trainer
    model = trainer.setup_model(cfg, model_cfg, "retrieval", "cuda")
    oc = trainer.optim_config_from_run(cfg)
    meta = optim.build_group_meta(model, oc)
    state = steps.init_train_state(model, meta)
    ss = steps.ScheduleSettings(learning_rate=lr, cnn_learning_rate=lr,
                                decay="constant", cnn_decay="constant",
                                num_train_steps=LEARN_STEPS)
    return state, steps.make_train_step(model_cfg, ts, oc, ss, meta,
                                        compute_dtype=torch.bfloat16)


def main() -> None:
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    attn_err, attn_times = phase_attention(gen)
    mba_err, mba_times, _ = phase_matmul_bn_act(gen)
    stem_err, stem_times = phase_stem(gen)

    run_cfg = load_run_config(
        ["--config", os.path.join(ROOT, "configs",
                                  "msrvtt_ret_base_resnet50.json"),
         "--inference_video_batch_size", "8"])
    model_cfg = inject_task_attrs(ModelConfig.from_json(
        os.path.join(ROOT, run_cfg.model_config)), run_cfg)
    model = _model(model_cfg)
    with tempfile.TemporaryDirectory() as d:
        vocab = os.path.join(d, "vocab.txt")
        write_tiny_vocab(vocab, extra_tokens=CAPTION_WORDS)
        tok = BertTokenizer(vocab)
        phase_slice(model, model_cfg, tok)
        launches, matrix, wall, path, rows = phase_eval(
            model, model_cfg, tok, run_cfg, d)
        phase_bench(model, model_cfg)
        tp_launches, shard_err, shard_time, eval_outs = phase_tp(
            model, model_cfg, tok, d, gen, (run_cfg, tok, path, rows))
        phase_multiprocess_eval(model_cfg, run_cfg, tok, path, rows, matrix,
                                wall, eval_outs)
        phase_bodies(model, model_cfg, tok, run_cfg, path, rows, matrix)
        phase_stem_bodies(model, model_cfg, tok)
        phase_cnn_bodies(model, model_cfg, tok, run_cfg, path, rows, matrix)
        torch.cuda.empty_cache()
        t15 = time.perf_counter()
        qa_times, qa_err = phase_qa_kernels(gen)
        qa_models = _qa_models(model_cfg)
        qa_launches = phase_qa_scorers(qa_models, tok)
        qa_launches = [a + b for a, b in zip(qa_launches, phase_qa_runners(
            qa_models, model, model_cfg, tok, d, path))]
        print(f"phase 15: {time.perf_counter() - t15:.1f} s; the QA "
              f"family's scorers and runners launched attention "
              f"{qa_launches[0]} ({qa_launches[3]} on tc), matmul_bn_act "
              f"{qa_launches[1]} ({qa_launches[4]} on wg) and "
              f"fused_stem_pool {qa_launches[2]} ({qa_launches[5]} on tc) "
              "times")
        phase_train_autograd(tok)
        train_launches = phase_train(tok, d, path, rows)

    def record(name, source, replaces, n, err, t, design, qa=None):
        out = {"name": name, "route": "cuda",
               "source": f"clipbert_tpu_torch/csrc/{source}",
               "replaces": replaces, "launches": n, "max_abs_err": err,
               **t, "design": design}
        if qa is not None:
            # phase 15: launches on the QA family's main paths, the worst
            # bf16 error and the times at its shapes; phase 16: launches in
            # the training run (all in its validation)
            i = ("fused_attention", "matmul_bn_act",
                 "fused_stem_pool").index(name)
            out.update(qa_launches=qa_launches[i], qa_max_abs_err=qa_err[name],
                       qa_shapes=qa_times[name],
                       train_launches=train_launches[i])
        return out

    tc = ("body tc: QK^T and PV on mma.sync m16n8k16 (bf16 in, fp32 "
          "accumulate), exact full-row fp32 softmax in registers, P packed "
          "into the PV A fragments, K/V staged as bf16 by cp.async; one "
          "block per (batch item, head), one warp per 16 query rows "
          "(earlier_ms: body v2, fp32 CUDA cores, kept for fp32, S > 128 "
          "and dh % 16 != 0)")
    print(json.dumps({"kernels": [
        record("fused_attention", "fused_attention.cu",
               "clipbert_tpu/ops/pallas_attention.py:73", launches[0],
               attn_err, attn_times[(512, 69, 12, 64)], tc, qa=True),
        record("matmul_bn_act", "matmul_bn_act.cu",
               "clipbert_tpu/ops/pallas_kernels.py:65", launches[1], mba_err,
               mba_times[(FRAMES, 112, 112, 64, 256, True, 1, True)],
               "body wg: wgmma m64nNk16 (bf16 in, fp32 accumulate) in two "
               "consumer warpgroups, fed by a producer warp's TMA loads into "
               "a ring of 128B-swizzled shared-memory stages with mbarriers; "
               "persistent blocks (one per SM) over 128 x BN tiles, BN 64 or "
               "128 by N; BN scale/bias, residual and ReLU on the "
               "accumulators, the residual in and the output out by TMA "
               "through a ring of 128 x 64 shared-memory slots (earlier_ms: "
               "body mma, 128 x 128 tiles on mma.sync m16n8k16, kept for "
               "fp32 and operands TMA cannot describe)", qa=True),
        record("fused_stem_pool", "fused_stem_pool.cu",
               "clipbert_tpu/ops/pallas_stem.py:196", launches[2], stem_err,
               stem_times[FRAMES],
               "body tc: the 7x7/s2 conv as an implicit GEMM on mma.sync "
               "m16n8k16 (bf16 in, fp32 accumulate), K = 7 kernel rows x 22 "
               "taps (padded to 160) read straight from the staged NHWC halo "
               "rows through a per-lane tap-offset table (no im2col); one "
               "persistent block per SM, two 4-warp groups with their own "
               "8 x 7 pooled tiles taking turns on the tensor cores, the "
               "next halo in flight by cp.async; ReLU and one bf16 rounding "
               "into a shared conv tile that the 3x3/s2 max pool reads "
               "(earlier_ms: body direct, the direct conv on the fp32 CUDA "
               "cores, kept for fp32)", qa=True),
        record("fused_attention_shard_heads", "fused_attention.cu",
               "clipbert_tpu/ops/pallas_attention.py:132", tp_launches,
               shard_err, shard_time, tc + " on a rank's heads")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
