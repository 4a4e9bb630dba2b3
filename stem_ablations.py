#!/usr/bin/env python3
"""Where the fused stem's tensor-core body spends its time, on one card.

    python3 stem_ablations.py

Builds variants of clipbert_tpu_torch/csrc/fused_stem_pool.cu, each with
one part of the tc body's work removed by a text substitution of the
committed source (so a variant's output is wrong and only its time
counts), and times them in turns as CUDA graph replays at 32 and 2 frames
of 448^2 (one 16-clip and one 1-clip request's CNN batch):

  full          the committed body (checked against the plain version)
  no_products   the 10 k16 steps skipped: the sums stay at the bias
  no_a_loads    the A fragments made from the row offsets, not loaded
  no_epilogue   no conv tile and no pool: the sums are reduced and dropped
  no_pool       the conv tile written, the pool skipped
  no_next_halo  the next tile's halo not loaded (tiles reuse a stale one)
  free_turns    the two groups of a block run their products without
                taking turns (the second waits only for the first's first)

full minus a variant is what that part costs where the rest does not hide
it. Prints the card's name and power limit as nvidia-smi gives them, each
size's windows, then one JSON line. Imports nothing of JAX; needs one card
and nvcc, about a minute.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke
from clipbert_tpu_torch.ops import _build
from clipbert_tpu_torch.ops import fused_stem_pool as fsp

SOURCE = _build.CSRC_DIR / "fused_stem_pool.cu"
PRODUCTS = ("#pragma unroll\n    for (int s = 0; s < kKSteps; ++s) {\n"
            "      uint32_t bk[8][2];")
A_LOADS = """        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(hb + lo[mt] + off.x),
            *reinterpret_cast<const uint32_t*>(hb + hi[mt] + off.x),
            *reinterpret_cast<const uint32_t*>(hb + lo[mt] + off.y),
            *reinterpret_cast<const uint32_t*>(hb + hi[mt] + off.y)};"""
EPILOGUE = ("    // ReLU, one rounding, 0 outside the image; into the conv "
            "tile\n")
DROP_SUMS = """    {
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < kTcWarpTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum += acc[mt][nt][e];
      if (sum == 1.2345f) a.out[tid] = 1;
      bar_sync(3 + grp, kTcGroupThreads);
      buf ^= 1;
      sh = sh_next;
      continue;
    }
"""
POOL = "    for (int i = gt; i < kTcPH * kTcPW * 8; i += kTcGroupThreads) {"
NEXT_HALO = ("        next < a.tiles ? tc_stage(halo + (buf ^ 1) * "
             "(kHaloBytes / 2), a,\n                                  next, "
             "gt)\n                       : 0;")
TURN_WAIT = "    if (j > 0) bar_sync(1 + grp, kTcThreads);"
TURN_SIGNAL = "    if (after < a.tiles) bar_arrive(1 + (grp ^ 1), kTcThreads);"

# variant: [(text of the committed source, its replacement)]
VARIANTS = {
    "full": [],
    "no_products": [(PRODUCTS, PRODUCTS.replace("s < kKSteps", "s < 0"))],
    "no_a_loads": [(A_LOADS, "        const uint32_t af[4] = {lo[mt] + "
                             "off.x, hi[mt] + off.x, lo[mt] + off.y, "
                             "hi[mt] + off.y};")],
    "no_epilogue": [(EPILOGUE, DROP_SUMS + EPILOGUE)],
    "no_pool": [(POOL, POOL.replace("i < kTcPH * kTcPW * 8", "i < 0"))],
    "no_next_halo": [(NEXT_HALO, "        0;")],
    "free_turns": [(TURN_WAIT, TURN_WAIT.replace("j > 0", "j == 1")),
                   (TURN_SIGNAL, TURN_SIGNAL.replace(
                       "after < a.tiles", "j == 0 && after < a.tiles"))],
}


def _variant_source(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the source does not hold, once: {old!r}")
        src = src.replace(old, new)
    return src


def _build_variants(workdir: Path):
    """{variant: its clipbert_fused_stem_pool}, one nvcc each, in
    parallel."""
    procs = {}
    for name, edits in VARIANTS.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(_variant_source(edits))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(workdir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        fn = lib.clipbert_fused_stem_pool
        fn.argtypes = fsp._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, x, w32, b, out, plan):
    B, H, W, _ = x.shape

    def run():   # on the current stream, which a graph capture replaces
        rc = fn(x.data_ptr(), w32.data_ptr(), b.data_ptr(), out.data_ptr(),
                1, B, H, W, fsp._BODY_CODES["tc"], 0, fsp._n_sms(0),
                plan.grid, plan.threads, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
    return run


def main() -> None:
    chip_smoke.phase_device()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    result = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        fns = _build_variants(Path(d))
        for B in (chip_smoke.FRAMES, 2):
            x, w, b = chip_smoke._stem_inputs(B, 448, 448, torch.bfloat16,
                                              gen)
            w32 = w.float().contiguous()
            plan = fsp._plan(B, 448, 448, torch.bfloat16, True,
                             fsp._n_sms(0))
            out = torch.empty((B, 112, 112, 64), dtype=torch.bfloat16,
                              device="cuda")
            _call(fns["full"], x, w32, b, out, plan)()
            ref = fsp.fused_stem_pool_reference(x, w, b)
            mag = F.conv2d(x.permute(0, 3, 1, 2).float().abs(),
                           w.to(torch.bfloat16).float().abs(), None, 2, 3)
            mag = F.max_pool2d(mag + b.abs()[None, :, None, None], 3, 2, 1)
            chip_smoke._check_close(f"stem tc body {(B, 448, 448)}", out,
                                    ref, mag.permute(0, 2, 3, 1),
                                    torch.bfloat16)
            iters = 10 if B == chip_smoke.FRAMES else 40
            order = list(fns) + list(fns)[::-1]
            ms = {name: [] for name in fns}
            for name in order:
                ms[name].append(chip_smoke._time_ms(
                    _call(fns[name], x, w32, b, out, plan), iters,
                    graph=True))
            print(f"stem tc body, {(B, 448, 448)} bf16 (device time, CUDA "
                  f"graph of {iters} calls, in turns): "
                  + ", ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in v)
                              for n, v in ms.items()) + " ms")
            result[B] = {n: sum(v) / len(v) for n, v in ms.items()}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": result}))


if __name__ == "__main__":
    main()
