#!/usr/bin/env python3
"""Smoke test of the PyTorch port (clipbert_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
 1. device: requires CUDA; prints the card's name and power limit as
    nvidia-smi gives them; turns TF32 off for the fp32 comparisons.
 2. build: compiles the three csrc/*.cu libraries with nvcc, one process
    per source, all started together (timed), and prints each one's ptxas
    register and spill lines.
 3. kernel vs plain, fused attention: the kernel against its plain PyTorch
    version at the serving, eval, ragged and longest shapes, fp32 and bf16,
    contiguous operands, strided views of one merged QKV tensor and views
    whose rows miss 16-byte alignment; timed with CUDA events at the
    serving and eval shapes beside SDPA.
 4. kernel vs plain, matmul_bn_act: every distinct 1x1 conv of ResNet-50 at
    32 frames of 448^2 plus ragged shapes, fp32 and bf16; timed at the
    res2 conv3 and a res4 conv1 shape beside addmm + residual + ReLU.
 5. kernel vs plain, fused_stem_pool: 32 x 448^2 and small and odd sizes,
    fp32 and bf16; timed at 32 frames beside cuDNN conv + bias + ReLU +
    max_pool2d.
 6. the serving slice at full width: RetrievalScorer on configs/
    base_model.json with random weights from a seeded generator, at 1 and
    16 clips, requests of 1, 5 and 32 captions on seeded uint8 240x320
    frames. Counts from 0: every scoring call must launch attention once
    per encoder layer, every encode 36 fused 1x1 convs and one fused stem.
    Then the CNN's kernel form and cuDNN form in turns; their grid features
    on the same frames must agree within FEAT_REL, and the kernel form with
    a planted wiring fault must not. Then one request through the plain
    attention path.
 7. the eval path at full width: tasks.run_video_retrieval.
    inference_retrieval with the configs/msrvtt_ret_base_resnet50.json
    settings (16 clips x 2 frames at 448^2, text length 20, bf16, folded
    BN) on a synthetic store of 16 seeded 240x320 JPEG-sequence videos and
    72 captions. Counts from 0: 36 + 1 CNN launches per encode, 12
    attention launches per prob dispatch. Then the same eval in the cuDNN
    form; the score matrices must agree within PROB_ATOL, and the first
    video group's grid features within FEAT_REL, as in phase 6.
 8. the bench unit (bench.py's mil_forward at 8 videos x 16 clips and 128
    videos x 1 clip), kernel form against cuDNN form in turns, clips/s.
 9. the last two lines: the kernels' JSON record, then
    {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs one card, nvcc and a few minutes.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from clipbert_tpu_torch.core.config import (ModelConfig, inject_task_attrs,
                                            load_run_config)
from clipbert_tpu_torch.data import store, transforms, video
from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
from clipbert_tpu_torch.data.tokenization import BertTokenizer, write_tiny_vocab
from clipbert_tpu_torch.models import clipbert, resnet
from clipbert_tpu_torch.ops import _build
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.ops import fused_stem_pool as fsp
from clipbert_tpu_torch.ops import matmul_bn_act as mba
from clipbert_tpu_torch.serve import RetrievalScorer, _pow2_bucket
from clipbert_tpu_torch.tasks import common
from clipbert_tpu_torch.tasks.run_video_retrieval import inference_retrieval
from clipbert_tpu_torch.train import steps

ROOT = os.path.dirname(os.path.abspath(__file__))
LIBRARIES = ("fused_attention", "matmul_bn_act", "fused_stem_pool")
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
# R50 1x1 convs per encode: conv1 and conv3 of 16 bottlenecks + 4 shortcuts
MBA_PER_ENCODE = 2 * sum(n for n, _, _ in resnet.R50_STAGES) + 4
FRAMES = 32        # 16 clips x 2 frames: one 16-clip request's CNN batch
EVAL_VIDEOS, EVAL_CAPTIONS = 16, 72


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


def phase_build() -> float:
    t0 = time.perf_counter()
    paths = _build.build_libraries(LIBRARIES)
    for kernel in (fa._kernel, mba._kernel, fsp._kernel):
        kernel()
    dt = time.perf_counter() - t0
    print(f"build: {len(paths)} libraries in {dt:.2f} s (one nvcc each, "
          "in parallel)")
    for name, path in paths.items():
        print(f"  {os.path.relpath(path, ROOT)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")
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


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(kern, plain, iters, library=None):
    """(kernel ms, plain ms, library ms): each timed twice in turns
    (plain, kernel, kernel, plain [, library, library])."""
    p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kern, kern, plain))
    lib = None
    if library is not None:
        lib = (_time_ms(library, iters) + _time_ms(library, iters)) / 2
    return (k1 + k2) / 2, (p1 + p2) / 2, lib, (k1, k2, p1, p2)


def phase_attention(gen):
    bf16_err = 0.0
    for B, S, H, dh, what in SHAPES:
        scale = 1.0 / dh ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            for layout in LAYOUTS:
                q, k, v, bias = _inputs(B, S, H, dh, dtype, layout, gen)
                # plain first: the kernel's fresh output buffer can then
                # never be a stale copy of this comparison's reference
                ref = fa.fused_attention_reference(q, k, v, bias, scale)
                out = fa.fused_attention(q, k, v, bias, scale)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                if dtype == torch.float32:
                    bound = FP32_TOL + FP32_TOL * ref.float().abs()
                    ok = bool((diff <= bound).all())
                else:
                    ok = err <= BF16_ATOL
                    bf16_err = max(bf16_err, err)
                print(f"kernel vs plain {(B, S, H, dh)} {what} "
                      f"{str(dtype)[6:]} {layout}: max_abs_err {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"fused_attention disagrees with its "
                                         f"plain version at {(B, S, H, dh)} "
                                         f"{dtype} {layout}: {err}")
                del q, k, v, bias, out, ref, diff
    times = {}
    for B, S, H, dh, what in TIMED:
        q, k, v, bias = _inputs(B, S, H, dh, torch.bfloat16,
                                "merged-qkv views", gen)
        scale = 1.0 / dh ** 0.5
        iters = 20 if B <= 512 else 5
        # SDPA with the same additive key mask, on (B, H, S, dh) views
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = bias[:, None, None, :].to(torch.bfloat16)
        k_ms, p_ms, lib_ms, (k1, k2, p1, p2) = _in_turns(
            lambda: fa.fused_attention(q, k, v, bias, scale),
            lambda: fa.fused_attention_reference(q, k, v, bias, scale),
            iters,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, mask,
                                                   scale=scale))
        nbytes = 4 * B * S * H * dh * 2 + B * S * 4
        bound = _bound_ms(4 * B * H * S * S * dh, nbytes)
        times[(B, S, H, dh)] = (k_ms, p_ms, lib_ms, bound)
        print(f"time bf16 {(B, S, H, dh)} {what}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
        del q, k, v, bias, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return bf16_err, times


def _r50_1x1_shapes(frames: int, img: int):
    """Every distinct (H, W, K, N, residual, stride) of ResNet-50's 1x1
    convs (stride on the 1x1 reduce conv, stride_in_1x1) for ``frames``
    frames of ``img``^2."""
    shapes, cin, hw = [], 64, img // 4
    for si, (n, cmid, cout) in enumerate(resnet.R50_STAGES):
        s = 1 if si == 0 else 2
        out_hw = hw // s
        shapes += [(hw, cin, cmid, False, s), (hw, cin, cout, False, s),
                   (out_hw, cmid, cout, True, 1)]
        if n > 1:
            shapes.append((out_hw, cout, cmid, False, 1))
        cin, hw = cout, out_hw
    return [(frames, h, h, K, N, res, s) for h, K, N, res, s in
            dict.fromkeys(shapes)]


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


def phase_matmul_bn_act(gen):
    shapes = _r50_1x1_shapes(FRAMES, 448) + [(1, 100, 1, 64, 96, True, 1),
                                              (1, 3, 1, 8, 8, False, 1)]
    bf16_err = 0.0
    for B, H, W, K, N, res, stride in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, H, W, K, device="cuda", generator=gen).to(dtype)
            w = torch.randn(N, K, 1, 1, device="cuda", generator=gen) * K ** -0.5
            sc = torch.rand(N, device="cuda", generator=gen) + 0.5
            b = torch.randn(N, device="cuda", generator=gen)
            Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
            r = (torch.randn(B, Ho, Wo, N, device="cuda", generator=gen)
                 .to(dtype) if res else None)
            xs = x[:, ::stride, ::stride].reshape(-1, K)
            r2 = None if r is None else r.reshape(-1, N)
            ref = mba.matmul_bn_act_reference(xs, w.reshape(N, K).t(), sc, b,
                                              r2)
            out = mba.conv1x1_bn_act(x, w, sc, b, stride, r).reshape(-1, N)
            torch.cuda.synchronize()
            mag = (xs.float().abs() @ w.reshape(N, K).to(dtype).float().abs()
                   .t()) * sc + b.abs()
            if r2 is not None:
                mag = mag + r2.float().abs()
            err = _check_close(f"matmul_bn_act R={B * Ho * Wo} K={K} N={N} "
                               f"residual={res} stride={stride}", out, ref,
                               mag, dtype)
            if dtype == torch.bfloat16:
                bf16_err = max(bf16_err, err)
            del x, w, r, xs, r2, ref, out, mag
    times = {}
    for R, K, N, res in ((FRAMES * 112 * 112, 64, 256, True),
                         (FRAMES * 28 * 28, 1024, 256, False)):
        dt = torch.bfloat16
        x = torch.randn(R, K, device="cuda", generator=gen).to(dt)
        w = (torch.randn(K, N, device="cuda", generator=gen)
             * K ** -0.5).to(dt)
        b = torch.randn(N, device="cuda", generator=gen)
        r = torch.randn(R, N, device="cuda", generator=gen).to(dt) if res \
            else None
        b16 = b.to(dt)

        def library():
            y = torch.addmm(b16, x, w)
            return torch.relu(y + r if r is not None else y)

        k_ms, p_ms, lib_ms, (k1, k2, p1, p2) = _in_turns(
            lambda: mba.matmul_bn_act(x, w, None, b, r),
            lambda: mba.matmul_bn_act_reference(x, w, None, b, r), 10,
            library)
        nbytes = (R * K + K * N + R * N * (2 if res else 1)) * 2 + N * 4
        bound = _bound_ms(2 * R * K * N, nbytes)
        times[(R, K, N, res)] = (k_ms, p_ms, lib_ms, bound)
        print(f"time bf16 matmul_bn_act R={R} K={K} N={N} residual={res}: "
              f"kernel {k1:.4f} / {k2:.4f} ms "
              f"({2 * R * K * N / k_ms / 1e9:.1f} TFLOP/s), plain {p1:.4f} / "
              f"{p2:.4f} ms, addmm+residual+relu {lib_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        del x, w, b, r, b16
    torch.cuda.empty_cache()
    return bf16_err, times


def _stem_inputs(B, H, W, dtype, gen):
    # caffe-normalized pixels reach +-130; He-normal stem weights
    x = (torch.randn(B, H, W, 3, device="cuda", generator=gen) * 60).to(dtype)
    w = torch.randn(64, 3, 7, 7, device="cuda", generator=gen) * 0.025
    b = torch.randn(64, device="cuda", generator=gen)
    return x, w, b


def phase_stem(gen):
    bf16_err = 0.0
    for B, H, W in ((FRAMES, 448, 448), (2, 64, 64), (1, 48, 80),
                    (1, 37, 53)):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _stem_inputs(B, H, W, dtype, gen)
            ref = fsp.fused_stem_pool_reference(x, w, b)
            out = fsp.fused_stem_pool(x, w, b)
            torch.cuda.synchronize()
            mag = F.conv2d(x.permute(0, 3, 1, 2).float().abs(),
                           w.to(dtype).float().abs(), None, 2, 3)
            mag = F.max_pool2d(mag + b.abs()[None, :, None, None], 3, 2, 1)
            err = _check_close(f"fused_stem_pool {(B, H, W)} -> "
                               f"{tuple(out.shape)}", out, ref,
                               mag.permute(0, 2, 3, 1), dtype)
            if dtype == torch.bfloat16:
                bf16_err = max(bf16_err, err)
            del x, w, b, ref, out, mag
    x, w, b = _stem_inputs(FRAMES, 448, 448, torch.bfloat16, gen)
    xc = x.permute(0, 3, 1, 2)                    # channels_last view
    wc = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b16 = b.to(torch.bfloat16)[None, :, None, None]
    k_ms, p_ms, lib_ms, (k1, k2, p1, p2) = _in_turns(
        lambda: fsp.fused_stem_pool(x, w, b),
        lambda: fsp.fused_stem_pool_reference(x, w, b), 10,
        lambda: F.max_pool2d(torch.relu(F.conv2d(xc, wc, None, 2, 3) + b16),
                             3, 2, 1))
    nbytes = (FRAMES * 448 * 448 * 3 + FRAMES * 112 * 112 * 64) * 2 + \
        64 * 147 * 2 + 64 * 4
    bound = _bound_ms(2 * FRAMES * 224 * 224 * 64 * 147, nbytes)
    print(f"time bf16 fused_stem_pool {(FRAMES, 448, 448)}: kernel "
          f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, cuDNN "
          f"conv+bias+relu+max_pool2d {lib_ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    del x, w, b, xc, wc, b16
    torch.cuda.empty_cache()
    return bf16_err, (k_ms, p_ms, lib_ms, bound)


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
    gap = _rel_gap(encode("kernels"), ref)
    print(f"{what}: grid features, kernel form vs cuDNN form: relative gap "
          f"{gap:.3e} (bound {FEAT_REL})")
    if not gap <= FEAT_REL:
        raise AssertionError(f"{what}: the CNN's two forms' grid features "
                             f"differ by {gap} > {FEAT_REL}")
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
    fa.LAUNCHES = mba.LAUNCHES = fsp.LAUNCHES = 0


def _counts():
    return fa.LAUNCHES, mba.LAUNCHES, fsp.LAUNCHES


def _expect(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got} launches, expected {want}")


def _model(cfg):
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = clipbert.init_clipbert(cfg, "retrieval", generator=gen,
                                   device="cuda")
    clipbert.fold_cnn_bn_scales(model)
    model.eval().requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, {cfg.num_hidden_layers} layers, "
          f"hidden {cfg.hidden_size}, random init on cuda in "
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
                _expect("encode, matmul_bn_act", d[1], MBA_PER_ENCODE)
                _expect("encode, fused_stem_pool", d[2], 1)
    launches = _counts()
    print(f"serving path: {n_calls} requests launched attention "
          f"{launches[0]}, matmul_bn_act {launches[1]} and fused_stem_pool "
          f"{launches[2]} times ({cfg.num_hidden_layers}, {MBA_PER_ENCODE} "
          "and 1 per request)")
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


def phase_eval(model, model_cfg, tok, cfg):
    rng = np.random.default_rng(5)
    results = {}
    with tempfile.TemporaryDirectory() as d:
        path, rows = _eval_store(d, rng)
        n_cap_batches = -(-EVAL_CAPTIONS // cfg.inference_batch_size)
        for form in ("kernels", "cudnn"):
            ds = VideoRetrievalEvalDataset(
                rows, tok, store.open_store(path), fps=cfg.fps,
                num_frm=cfg.num_frm, max_img_size=cfg.max_img_size,
                max_txt_len=cfg.max_txt_len,
                ensemble_n_clips=cfg.inference_n_clips,
                device_preprocess=cfg.device_preprocess)
            stats = {}
            if form == "kernels":
                # ---- the main path: counts from 0, read right after ----
                _reset_counts()
            t0 = time.perf_counter()
            m = inference_retrieval(cfg, model_cfg, model, ds,
                                    torch.bfloat16, stats,
                                    use_kernels=form == "kernels")
            wall = time.perf_counter() - t0
            if form == "kernels":
                launches = _counts()
                g = stats["n_groups"]
                _expect("eval, attention", launches[0],
                        model_cfg.num_hidden_layers * g * n_cap_batches)
                _expect("eval, matmul_bn_act", launches[1],
                        MBA_PER_ENCODE * g)
                _expect("eval, fused_stem_pool", launches[2], g)
                print(f"eval path: {g} video groups x {n_cap_batches} "
                      f"caption minibatches launched attention "
                      f"{launches[0]}, matmul_bn_act {launches[1]} and "
                      f"fused_stem_pool {launches[2]} times")
            sm = m["score_matrix"]
            if sm.shape != (EVAL_VIDEOS, EVAL_CAPTIONS) or \
                    not np.isfinite(sm).all() or \
                    not ((sm >= 0) & (sm <= 1)).all():
                raise AssertionError(f"bad score matrix {sm.shape}")
            if ds.n_fallbacks:
                raise AssertionError(f"{ds.n_fallbacks} videos did not "
                                     "decode")
            recall = {k: v for k, v in m.items() if k != "score_matrix"}
            print(f"eval, {form} form: wall {wall:.3f} s; stage stats "
                  + json.dumps({k: round(v, 4) if isinstance(v, float)
                                else v for k, v in stats.items()}))
            print(f"eval, {form} form: R@K {json.dumps(recall)}")
            results[form] = sm
        _check_eval_cnn_forms(model, model_cfg, cfg, ds)
    err =float(np.abs(results["kernels"] - results["cudnn"]).max())
    print(f"eval score matrices, kernel form vs cuDNN form: max_abs_diff "
          f"{err:.3e} (bound {PROB_ATOL})")
    if err > PROB_ATOL:
        raise AssertionError(f"eval score matrices disagree by {err}")
    return launches


def phase_bench(model, cfg):
    """bench.py's unit (mil_forward, no fused attention, folded BN, bf16) at
    8 videos x 16 clips and 128 videos x 1 clip, both CNN forms in turns."""
    rng = np.random.default_rng(0)
    for nc, bv in ((16, 8), (1, 128)):
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


def main() -> None:
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    attn_err, attn_times = phase_attention(gen)
    mba_err, mba_times = phase_matmul_bn_act(gen)
    stem_err, stem_time = phase_stem(gen)

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
    launches = phase_eval(model, model_cfg, tok, run_cfg)
    phase_bench(model, model_cfg)

    def record(name, source, replaces, n, err, t):
        k_ms, p_ms, lib_ms, (b_ms, b_by) = t
        return {"name": name, "route": "cuda",
                "source": f"clipbert_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}

    print(json.dumps({"kernels": [
        record("fused_attention", "fused_attention.cu",
               "clipbert_tpu/ops/pallas_attention.py:73", launches[0],
               attn_err, attn_times[(512, 69, 12, 64)]),
        record("matmul_bn_act", "matmul_bn_act.cu",
               "clipbert_tpu/ops/pallas_kernels.py:65", launches[1], mba_err,
               mba_times[(FRAMES * 112 * 112, 64, 256, True)]),
        record("fused_stem_pool", "fused_stem_pool.cu",
               "clipbert_tpu/ops/pallas_stem.py:196", launches[2], stem_err,
               stem_time)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
