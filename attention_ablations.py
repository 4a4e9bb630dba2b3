#!/usr/bin/env python3
"""Where the attention kernel's tensor-core body spends its time, and how
it should split a (batch item, head) over blocks, on one card.

    python3 attention_ablations.py

The tc body runs one warp per 16 query rows and splits the query tiles of
a (batch item, head) over blocks of at most ``kTcBlockWarps`` warps, each
block staging all of that (b, h)'s K and V. This builds variants of
clipbert_tpu_torch/csrc/fused_attention.cu by text substitutions of the
committed source (and only the dh = 64 instantiations kept, to build
faster) and times them in turns as CUDA graph replays at the QA family's
shapes and the retrieval path's S = 69 shapes:

  committed  the source as it is
  w16        one block per (b, h), as many warps as query tiles (up to 11)
  w4         at most 4 warps a block
  div        p = e / sum divided, not multiplied by 1 / sum
  fast_exp   __expf (ex2.approx) in place of expf
  no_exp     (timing only) the exponentials left out
  no_qk      (timing only) the Q K^T products left out
  no_pv      (timing only) the P V products left out

The variants that keep the function are checked against the plain version
first (per 16-row query tile where they miss BF16_ATOL); a timing-only
variant's output is wrong and only its time counts: committed minus it is
what that part costs where the rest does not hide it. SDPA on the same
operands is timed beside them as the yardstick. Prints the card's name and
power limit as nvidia-smi gives them, each shape's windows, then one JSON
line. Imports nothing of JAX; needs one card and nvcc, about three minutes
with chip_smoke.py's build of the three kernel libraries (whose ptxas
report it prints, refusing a spill).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke
from clipbert_tpu_torch.ops import _build
from clipbert_tpu_torch.ops import fused_attention as fa

SOURCE = _build.CSRC_DIR / "fused_attention.cu"
BLOCK_WARPS = "constexpr int kTcBlockWarps = {};"
RECIP = "pack_bf16(lo[0] * inv0, lo[1] * inv0)"
EXP = "      sc[n][0] = expf(sc[n][0] - mx0);\n"
EXPS = "".join(EXP.replace("[0]", f"[{e}]").replace("mx0", f"mx{e // 2}")
               for e in range(4))
QK = "    for (int ks = 0; ks < DK; ++ks) {\n#pragma unroll\n      for (int np"
PV = "  for (int kt = 0; kt < KT; ++kt) {\n#pragma unroll\n    for (int dp"


# variant: (kTcBlockWarps, [(text of the committed source, its
# replacement)], whether it keeps the function)
VARIANTS = {
    "committed": (fa.TC_BLOCK_WARPS, [], True),
    "w16": (16, [], True),
    "w4": (4, [], True),
    "div": (fa.TC_BLOCK_WARPS, [(
        f"{RECIP};\n      pf[kt][1] = pack_bf16(lo[2] * inv1, lo[3] * inv1);"
        "\n      pf[kt][2] = pack_bf16(hi[0] * inv0, hi[1] * inv0);\n"
        "      pf[kt][3] = pack_bf16(hi[2] * inv1, hi[3] * inv1);",
        "pack_bf16(lo[0] / sum0, lo[1] / sum0);\n"
        "      pf[kt][1] = pack_bf16(lo[2] / sum1, lo[3] / sum1);\n"
        "      pf[kt][2] = pack_bf16(hi[0] / sum0, hi[1] / sum0);\n"
        "      pf[kt][3] = pack_bf16(hi[2] / sum1, hi[3] / sum1);")], True),
    "fast_exp": (fa.TC_BLOCK_WARPS, [(EXPS, EXPS.replace("expf", "__expf"))],
                 True),
    "no_exp": (fa.TC_BLOCK_WARPS, [(EXPS, EXPS.replace("expf", ""))], False),
    "no_qk": (fa.TC_BLOCK_WARPS, [(QK, QK.replace("ks < DK", "ks < 0"))],
              False),
    "no_pv": (fa.TC_BLOCK_WARPS, [(PV, PV.replace("kt < KT", "kt < 0"))],
              False),
}
SHAPES = [s[:4] for s in chip_smoke.QA_ATTN_SHAPES[:4]] + [
    (32, 69, 12, 64), (512, 69, 12, 64), (8192, 69, 12, 64)]
# checked only: 8 to 11 query tiles, one block per (b, h) in w16
CHECKED = [(4, 128, 12, 64), (4, 144, 12, 64), (4, 160, 12, 64),
           (4, 176, 12, 64)]


def _variant_source(block_warps: int, edits) -> str:
    src = SOURCE.read_text()
    committed = BLOCK_WARPS.format(fa.TC_BLOCK_WARPS)
    for old, new in [(committed, BLOCK_WARPS.format(block_warps))] + edits:
        if src.count(old) != 1:
            raise AssertionError(f"the source does not hold, once: {old!r}")
        src = src.replace(old, new)
    # keep the dh = 64 instantiations only
    src, n = re.subn(r"    CLIPBERT_DK\([1235678]\)\n", "", src)
    if n != 7:
        raise AssertionError(f"{n} of 7 instantiations of DK != 4 removed")
    return src


def _build_variants(workdir: Path):
    """{variant: its clipbert_fused_attention}, one nvcc each, in
    parallel."""
    procs = {}
    for name, (w, edits, _) in VARIANTS.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(_variant_source(w, edits))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(workdir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for kern, (regs, st, ld) in chip_smoke._ptxas_report(log).items():
            if "tc_kernel" in kern:
                print(f"  {name} ptxas: {kern}: {regs} registers, spill "
                      f"stores {st} B, spill loads {ld} B")
        fn = ctypes.CDLL(str(workdir / f"{name}.so")).clipbert_fused_attention
        fn.argtypes = fa._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, block_warps, q, k, v, bias, scale, out):
    B, S, H, dh = q.shape
    tiles, splits, warps = fa._tc_split(S, block_warps)
    plan = fa._plan(B, S, H, dh, torch.bfloat16, fa._aligned16(q, k, v))
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]

    def run():   # on the current stream, which a graph capture replaces
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), 1, fa._BODY_CODES["tc"], B, S, H, dh,
                *strides, scale, B * H * splits, 32 * warps,
                plan.smem_bytes, int(plan.vec),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
    return run


def _check(name, run, out, ref, shape) -> bool:
    """The variant against the plain version; where it misses BF16_ATOL,
    the worst error of each 16-row query tile."""
    run()
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if err <= chip_smoke.BF16_ATOL:
        return True
    B, S, H, dh = shape
    rows = diff.amax(dim=(0, 2, 3))
    tiles = [rows[i:i + 16].max().item() for i in range(0, S, 16)]
    print(f"  FAIL variant {name} at {shape}: max_abs_err {err:.3e}; per "
          f"query tile " + ", ".join(f"{e:.2e}" for e in tiles))
    return False


def main() -> None:
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    result, failed = {}, []
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        fns = _build_variants(Path(d))
        for shape in CHECKED:
            q, k, v, bias = chip_smoke._inputs(*shape, torch.bfloat16,
                                               "merged-qkv views", gen)
            scale = shape[3] ** -0.5
            ref = fa.fused_attention_reference(q, k, v, bias, scale)
            for name, fn in fns.items():
                out = torch.empty(ref.shape, dtype=ref.dtype, device="cuda")
                if VARIANTS[name][2] and not _check(
                        name, _call(fn, VARIANTS[name][0], q, k, v, bias,
                                    scale, out), out, ref, shape):
                    failed.append((name, shape))
        for B, S, H, dh in SHAPES:
            q, k, v, bias = chip_smoke._inputs(B, S, H, dh, torch.bfloat16,
                                               "merged-qkv views", gen)
            scale = dh ** -0.5
            ref = fa.fused_attention_reference(q, k, v, bias, scale)
            runs = {}
            for name, fn in fns.items():
                out = torch.empty(ref.shape, dtype=ref.dtype, device="cuda")
                runs[name] = _call(fn, VARIANTS[name][0], q, k, v, bias,
                                   scale, out)
                if VARIANTS[name][2] and not _check(
                        name, runs[name], out, ref, (B, S, H, dh)):
                    failed.append((name, (B, S, H, dh)))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = bias[:, None, None, :].to(torch.bfloat16)
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, mask, scale=scale)
            iters = 20 if B <= 512 else 5
            order = list(runs) + list(runs)[::-1]
            ms = {name: [] for name in runs}
            for name in order:
                ms[name].append(chip_smoke._time_ms(runs[name], iters,
                                                    graph=True))
            bound = chip_smoke._bound_ms(4 * B * H * S * S * dh,
                                         4 * B * S * H * dh * 2 + B * S * 4)
            print(f"tc body {(B, S, H, dh)} bf16 merged-qkv (device time, "
                  f"CUDA graph of {iters} calls, in turns): "
                  + ", ".join(f"{n} " + " / ".join(f"{t:.4f}" for t in v)
                              for n, v in ms.items())
                  + f" ms; bound {bound[0]:.4f} ms ({bound[1]})")
            result[str((B, S, H, dh))] = dict(
                {n: sum(v) / len(v) for n, v in ms.items()},
                bound=bound[0])
            del q, k, v, bias, ref, runs
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": result, "failed": [
                          f"{n} at {s}" for n, s in failed]}))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
