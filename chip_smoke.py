#!/usr/bin/env python3
"""Smoke test of the PyTorch port (clipbert_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
 1. device: requires CUDA; prints the card's name and power limit as
    nvidia-smi gives them; turns TF32 off for the fp32 comparisons.
 2. build: compiles csrc/fused_attention.cu with nvcc (timed).
 3. kernel vs plain: the fused-attention CUDA kernel against its plain
    PyTorch version at the serving, eval, ragged and longest shapes, fp32
    and bf16, contiguous operands, strided views of one merged QKV tensor
    and views whose rows miss 16-byte alignment; both timed with CUDA
    events at the serving and eval shapes.
 4. the slice at full width: RetrievalScorer on configs/base_model.json
    with random weights from a seeded generator, at 1 and 16 clips; each
    answers requests of 1, 5 and 32 captions on seeded uint8 240x320
    frames through encode_frames + score. Every scoring call must launch
    the kernel once per encoder layer; one request is re-scored through
    the plain attention path and compared.
 5. the last two lines: the kernels' JSON record, then
    {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs one card, nvcc and about a minute.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data.tokenization import BertTokenizer, write_tiny_vocab
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import _build
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.serve import RetrievalScorer, _pow2_bucket
from clipbert_tpu_torch.train import steps

ROOT = os.path.dirname(os.path.abspath(__file__))

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
CAPTION_WORDS = ["a", "man", "woman", "is", "playing", "guitar", "cooking",
                 "in", "the", "kitchen", "dog", "runs", "on", "beach", "car",
                 "driving", "down", "road", "people", "dancing", "stage",
                 "cat", "sits", "near", "window", "child", "swimming"]
REQUEST_SIZES = (1, 5, 32)
REPEATS = 5


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
    path = _build.library_path("fused_attention")
    fa._kernel()
    dt = time.perf_counter() - t0
    print(f"build: {os.path.relpath(path, ROOT)} in {dt:.2f} s")
    log = path.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return dt


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


def phase_kernel(gen):
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

        def kern():
            return fa.fused_attention(q, k, v, bias, scale)

        def plain():
            return fa.fused_attention_reference(q, k, v, bias, scale)

        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kern, kern,
                                                        plain))
        times[(B, S, H, dh)] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time bf16 {(B, S, H, dh)} {what}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
        del q, k, v, bias
    torch.cuda.empty_cache()
    return bf16_err, times


def _captions(rng, n):
    return [" ".join(rng.choice(CAPTION_WORDS, size=rng.integers(5, 13)))
            for _ in range(n)]


def phase_slice():
    cfg = ModelConfig.from_json(os.path.join(ROOT, "configs",
                                             "base_model.json"),
                                num_labels=2, loss_type="ce",
                                score_agg_func="lse")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = clipbert.init_clipbert(cfg, "retrieval", generator=gen,
                                   device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, {cfg.num_hidden_layers} layers, "
          f"hidden {cfg.hidden_size}, random init on cuda in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        vocab = os.path.join(d, "vocab.txt")
        write_tiny_vocab(vocab, extra_tokens=CAPTION_WORDS)
        tok = BertTokenizer(vocab)
    caps = _captions(rng, max(REQUEST_SIZES))
    common = dict(device="cuda", compute_dtype=torch.bfloat16, num_frm=2,
                  max_img_size=448, max_txt_len=20, max_captions=32)
    scorers = {nc: RetrievalScorer(model, cfg, tok, n_clips=nc, **common)
               for nc in (1, 16)}
    frames = {nc: rng.integers(0, 256, (nc * 2, 240, 320, 3), np.uint8)
              for nc in scorers}
    for nc, sc in scorers.items():
        t0 = time.perf_counter()
        sc.warmup(((240, 320),))
        torch.cuda.synchronize()
        print(f"warmup {nc} clip(s): {time.perf_counter() - t0:.2f} s")

    # ---- the main path: counts from 0, read right after ------------------
    fa.LAUNCHES = 0
    lat = {nc: {n: [] for n in REQUEST_SIZES} for nc in scorers}
    split = {nc: {"encode": [], "score": []} for nc in scorers}
    for nc, sc in scorers.items():
        for _ in range(REPEATS):
            for n in REQUEST_SIZES:
                before = fa.LAUNCHES
                t0 = time.perf_counter()
                feats = sc.encode_frames(frames[nc])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                probs = sc.score(None, caps[:n], features=feats)
                t2 = time.perf_counter()
                lat[nc][n].append(t2 - t0)
                split[nc]["encode"].append(t1 - t0)
                split[nc]["score"].append(t2 - t1)
                if probs.shape != (n,) or not np.isfinite(probs).all() or \
                        not ((probs >= 0) & (probs <= 1)).all():
                    raise AssertionError(f"{nc} clips, {n} captions: bad "
                                         f"probabilities {probs}")
                if fa.LAUNCHES - before != cfg.num_hidden_layers:
                    raise AssertionError(
                        f"scoring call ran the kernel "
                        f"{fa.LAUNCHES - before} times, expected "
                        f"{cfg.num_hidden_layers}")
    launches = fa.LAUNCHES
    n_calls = len(scorers) * REPEATS * len(REQUEST_SIZES)
    print(f"main path: {n_calls} scoring calls launched the kernel "
          f"{launches} times ({cfg.num_hidden_layers} per call)")

    for nc in scorers:
        per = ", ".join(f"{n} caption(s) {np.median(lat[nc][n]) * 1e3:.2f} ms"
                        for n in REQUEST_SIZES)
        allp = np.median([x for v in lat[nc].values() for x in v]) * 1e3
        print(f"p50 request latency, {nc} clip(s) (encode_frames + score, "
              f"{REPEATS} repeats): {per}; all requests {allp:.2f} ms; "
              f"encode p50 {np.median(split[nc]['encode']) * 1e3:.2f} ms, "
              f"score p50 {np.median(split[nc]['score']) * 1e3:.2f} ms")

    # ---- the same request through the plain attention path (a test call)
    ts = steps.TaskSettings(head_type="retrieval", loss_type="ce",
                            score_agg_func="lse")
    plain_step = steps.make_text_prob_step(cfg, ts, torch.bfloat16,
                                           fused_attn=False)
    worst = 0.0
    for nc, sc in scorers.items():
        feats = sc.encode_frames(frames[nc])
        n = 5
        ids, mask = sc._pad_texts(caps[:n], _pow2_bucket(n, 32))
        plain = plain_step(sc.model, feats, ids, mask)[0, :n].cpu().numpy()
        kern = sc.score(None, caps[:n], features=feats)
        err = float(np.abs(plain - kern).max())
        worst = max(worst, err)
        print(f"{nc} clip(s), {n} captions: kernel path {np.round(kern, 5)} "
              f"plain path {np.round(plain, 5)} max_abs_err {err:.3e}")
        if err > PROB_ATOL:
            raise AssertionError(f"kernel and plain scoring paths disagree "
                                 f"by {err} > {PROB_ATOL}")
    return launches, worst


def main() -> None:
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16_err, times = phase_kernel(gen)
    launches, _ = phase_slice()
    k_ms, p_ms = times[(512, 69, 12, 64)]
    print(json.dumps({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "clipbert_tpu_torch/csrc/fused_attention.cu",
        "replaces": "clipbert_tpu/ops/pallas_attention.py:73",
        "launches": launches, "max_abs_err": bf16_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
