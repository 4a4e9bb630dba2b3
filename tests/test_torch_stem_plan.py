"""The fused stem kernel's launch plan (clipbert_tpu_torch/ops/
fused_stem_pool.py::_plan), its binding, and the tensor-core body's
formulation, on the CPU.

The kernel itself (csrc/fused_stem_pool.cu) builds and runs only on the
card, where ``python3 chip_smoke.py`` holds both of its bodies against the
plain version. Here: which body the plan picks (the tensor-core body "tc"
for bf16 with 16-byte aligned input and output, which is the main path at
32 and 2 frames of 448^2; the direct body for fp32 and the rest), the
plan's grid, threads, tile and shared-memory bytes against the constants
parsed from the source, that the C signature and the codes the wrapper
relies on are the source's, and that a CPU tensor still takes the plain
version with no counter moved.

Then the tc body's arithmetic in plain torch, with the source's layout: K
is 7 kernel rows of kKRow = 22 taps (tap 0 the element before the row's
first pixel, taps 1..21 the 7 pixels x 3 channels, padded to kK = 160 with
zero weights), B the packed weight (64 x 160) with zeros at the padded
taps, and A each conv output's 22-element runs of the staged, zero-padded
NHWC input rows read through ``as_strided`` (conv column j + 1 starts 6
elements after column j, conv row r + 1 two input rows below row r). In
fp32 that equals the plain version within rtol = atol = 1e-5 (the sum's
order differs), at the chip check's small sizes, an odd size and one
448^2 frame; and the JAX package's Pallas stem (interpret mode) within
tests/test_torch_cnn_kernels.py's STEM_TOL."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from clipbert_tpu.ops import pallas_stem as j_stem
from clipbert_tpu_torch.ops import fused_stem_pool as fsp

SRC = (Path(fsp.__file__).resolve().parents[1] / "csrc"
       / "fused_stem_pool.cu").read_text()
BF16, FP32 = torch.bfloat16, torch.float32
N_SMS = 132                                 # an H100 SXM
FORM_TOL = dict(rtol=1e-5, atol=1e-5)
STEM_TOL = dict(rtol=1e-4, atol=1e-4)       # test_torch_cnn_kernels.py


def _cu_consts() -> dict:
    """Every namespace-level ``constexpr int`` of the source, evaluated in
    order with C's integer division."""
    env = {}
    for m in re.finditer(r"^constexpr int ([^;]+);", SRC, re.M):
        for part in m.group(1).split(","):
            k, v = (t.strip() for t in part.split("=", 1))
            env[k] = eval(v.replace("/", "//"), {}, env)
    return env


CU = _cu_consts()


def _tiles(B, H, W, tile):
    Hp, Wp = fsp._out_hw(H, W)
    return -(-Hp // tile[0]) * -(-Wp // tile[1]) * B


def test_plan_constants_are_the_sources():
    assert fsp._TC_TILE == (CU["kTcPH"], CU["kTcPW"]) == (8, 7)
    assert fsp._TC_GROUPS == CU["kTcGroups"] == 2
    assert fsp._TC_THREADS == CU["kTcThreads"] == 256
    assert fsp._TC_SMEM == CU["kTcSmem"] <= 227 * 1024
    assert fsp._DIRECT_TILE == (CU["PH"], CU["PW"])
    assert fsp._DIRECT_THREADS == CU["kThreads"]
    assert fsp._DIRECT_SMEM == CU["kSmemFloats"] * 4
    assert fsp._PLAN_MISMATCH == CU["kPlanMismatch"]
    assert fsp._BODY_CODES == {"direct": CU["kBodyDirect"],
                               "tc": CU["kBodyTc"]}
    # the tc body's geometry: a 17 x 15 conv tile is 255 rows of M, 16 m16
    # tiles, 4 per warp, a group of 4 warps a tile
    assert (CU["kTcCR"], CU["kTcCC"], CU["kTcRows"]) == (17, 15, 255)
    assert CU["kTcMTiles"] == CU["kTcGroupWarps"] * CU["kTcWarpTiles"] == 16
    # K: 7 rows of 22 taps in 10 k16 steps; the halo row covers the last
    # conv column's taps from 4 elements past a 16-byte boundary
    assert (CU["kKRow"], CU["kK"], CU["kKSteps"]) == (22, 160, 10)
    assert CU["kHaloE"] >= 6 * (CU["kTcCC"] - 1) + CU["kKRow"] + 4
    # the grid and smem the entry point derives
    assert re.search(r"const long long pairs = \(tiles \+ kTcGroups - 1\) / "
                     r"kTcGroups;\n\s+const long long blocks = pairs < n_sms "
                     r"\? pairs : n_sms;", SRC)
    assert re.search(r"const bool can_tc = dtype == 1 && aligned;", SRC)


@pytest.mark.parametrize("B", [32, 2])
def test_plan_runs_the_main_path_on_tc(B):
    """One 16-clip request's 32 frames and one clip's 2, at the 448^2 the
    main path always sends: 112 = 14 x 8 = 16 x 7 pooled rows and columns,
    so no tile is partial, and every SM gets a block."""
    plan = fsp._plan(B, 448, 448, BF16, True, N_SMS)
    assert plan.body == "tc"
    assert plan.tile == (8, 7)
    tiles = _tiles(B, 448, 448, plan.tile)
    assert tiles == 224 * B
    assert plan.grid == min(-(-tiles // 2), N_SMS) == N_SMS
    assert (plan.threads, plan.smem_bytes) == (256, fsp._TC_SMEM)


@pytest.mark.parametrize("B,H,W", [(32, 448, 448), (2, 64, 64),
                                   (1, 48, 80), (1, 37, 53), (1, 9, 5),
                                   (3, 1, 1)])
def test_plan_keeps_direct_for_fp32(B, H, W):
    plan = fsp._plan(B, H, W, FP32, True, N_SMS)
    assert plan == fsp.Plan("direct", _tiles(B, H, W, (7, 8)), 256,
                            fsp._DIRECT_SMEM, (7, 8))


@pytest.mark.parametrize("B,H,W,grid", [(2, 64, 64, 6), (1, 48, 80, 3),
                                        (1, 37, 53, 2), (1, 9, 5, 1),
                                        (3, 1, 1, 2), (64, 448, 448, 132)])
def test_plan_odd_and_small_sizes_on_tc(B, H, W, grid):
    plan = fsp._plan(B, H, W, BF16, True, N_SMS)
    assert plan.body == "tc"
    assert plan.grid == grid == min(-(-_tiles(B, H, W, plan.tile) // 2),
                                    N_SMS)


def test_plan_unaligned_bf16_takes_direct():
    assert fsp._plan(2, 64, 64, BF16, False, N_SMS).body == "direct"
    with pytest.raises(ValueError):
        fsp._plan(2, 64, 64, BF16, False, N_SMS, body="tc")


@pytest.mark.parametrize("body,dtype,want", [
    ("direct", BF16, "direct"), ("direct", FP32, "direct"),
    ("tc", BF16, "tc")])
def test_forced_body(body, dtype, want):
    assert fsp._plan(32, 448, 448, dtype, True, N_SMS, body).body == want


@pytest.mark.parametrize("body,dtype", [("tc", FP32), ("wg", BF16),
                                        ("v2", FP32)])
def test_forced_body_the_kernel_does_not_have(body, dtype):
    with pytest.raises(ValueError):
        fsp._plan(32, 448, 448, dtype, True, N_SMS, body)


def test_argtypes_match_the_c_signature():
    sig = re.search(r'extern "C" int clipbert_fused_stem_pool\((.*?)\)',
                    SRC, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").split()
        want.append(ctype[" ".join(words[:-1])])
    assert fsp._ARGTYPES == want


def test_aligned16():
    x = torch.zeros(2, 4, 4, 3, dtype=BF16)
    assert fsp._aligned16(x)
    assert not fsp._aligned16(torch.zeros(97, dtype=BF16)[1:].view(2, 4, 4,
                                                                   3))


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_cpu_tensors_take_the_plain_version(rng_np, dtype):
    x = torch.from_numpy(rng_np.standard_normal((2, 20, 12, 3))
                         .astype(np.float32) * 60).to(dtype)
    w = torch.from_numpy((rng_np.standard_normal((64, 3, 7, 7)) * 0.025)
                         .astype(np.float32))
    b = torch.from_numpy(rng_np.standard_normal(64).astype(np.float32))
    counts = (fsp.LAUNCHES, fsp.TC_LAUNCHES)
    got = fsp.fused_stem_pool(x, w, b)
    assert (fsp.LAUNCHES, fsp.TC_LAUNCHES) == counts
    assert got.dtype == dtype and tuple(got.shape) == (2, 5, 3, 64)
    torch.testing.assert_close(got, fsp.fused_stem_pool_reference(x, w, b),
                               rtol=0, atol=0)


def _packed_weight(weight: torch.Tensor) -> torch.Tensor:
    """B as the tc body packs it: (kK, 64), row kKRow ky + 1 + 3 kx + c the
    weight of (c, ky, kx), the other rows 0."""
    k_row, k_all = CU["kKRow"], CU["kK"]
    b = torch.zeros(k_all, 64, dtype=weight.dtype)
    for ky in range(7):
        # (64, 3, 7) -> (7 kx, 3 c, 64): tap 1 + 3 kx + c
        taps = weight[:, :, ky, :].permute(2, 1, 0).reshape(21, 64)
        b[k_row * ky + 1:k_row * ky + 22] = taps
    return b


def _tc_formulation(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The tc body's sum in plain torch (fp32): the conv as A @ B with A
    read from the staged input rows by as_strided, then + bias, ReLU, 0 at
    conv positions outside the image, the 3x3/s2 max pool."""
    k_row, k_all = CU["kKRow"], CU["kK"]
    B, H, W, _ = x.shape
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    # the conv's zero padding (3 rows / pixels before, enough after), then
    # each row flattened to elements with one element staged before the
    # first pixel, and room after the last row for the runs that start there
    xp = F.pad(x.float(), (0, 0, 3, 2 * Wc + 8, 3, 2 * Hc + 8))
    row = xp.shape[2] * 3
    flat = F.pad(xp.reshape(B, xp.shape[1] * row), (1, row))
    runs = [flat.as_strided((B, Hc, Wc, k_row),
                            (flat.stride(0), 2 * row, 6, 1),
                            flat.storage_offset() + ky * row)
            for ky in range(7)]
    a = torch.cat(runs, dim=-1)                        # (B, Hc, Wc, 154)
    a = F.pad(a, (0, k_all - 7 * k_row))               # zero-weight taps
    conv = a.reshape(-1, k_all) @ _packed_weight(weight.float())
    conv = torch.relu(conv + bias.float()).reshape(B, Hc, Wc, 64)
    # pool padding: 0, exact after ReLU (each window holds a real output)
    pooled = F.max_pool2d(F.pad(conv.permute(0, 3, 1, 2), (1, 1, 1, 1)), 3,
                          2)
    return pooled.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 37, 53), (1, 9, 5),
                                   (1, 448, 448)])
def test_tc_formulation_equals_the_plain_version(rng_np, shape):
    x = torch.from_numpy(rng_np.standard_normal(shape + (3,))
                         .astype(np.float32) * 60)
    w = torch.from_numpy((rng_np.standard_normal((64, 3, 7, 7)) * 0.025)
                         .astype(np.float32))
    b = torch.from_numpy(rng_np.standard_normal(64).astype(np.float32))
    got = _tc_formulation(x, w, b)
    want = fsp.fused_stem_pool_reference(x, w, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **FORM_TOL)


def test_tc_formulation_matches_pallas(rng_np):
    """Against the JAX package's Pallas stem (interpret mode on the CPU),
    with the BN scale folded into the port's weight."""
    x = rng_np.standard_normal((2, 64, 64, 3)).astype(np.float32)
    k = (rng_np.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
    scale = (0.5 + rng_np.random(64)).astype(np.float32)
    bias = rng_np.standard_normal(64).astype(np.float32)
    want = j_stem.fused_stem_pool(
        jnp.asarray(x), jnp.asarray(j_stem.pack_stem_weights(k, scale)),
        jnp.asarray(bias))
    folded = k.transpose(3, 2, 0, 1) * scale[:, None, None, None]
    got = _tc_formulation(torch.from_numpy(x), torch.from_numpy(folded),
                          torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEM_TOL)
