"""The fused 1x1 conv kernel's launch plan (clipbert_tpu_torch/ops/
matmul_bn_act.py::_plan) and its binding, on the CPU.

The kernel itself (csrc/matmul_bn_act.cu) builds and runs only on the card,
where ``python3 chip_smoke.py`` holds both of its bodies against the plain
version. Here: which body the plan picks (the wgmma body "wg" at every
bf16 1x1 conv of ResNet-50, strided ones included; the mma.sync body "mma"
for fp32 and for operands TMA cannot describe), the plan's tile width,
stages, shared-memory bytes and grid against the formulas of the source,
that the constants and the C signature the wrapper relies on are the
source's, that a CPU tensor still takes the plain version with no counter
moved, and that the plain version matches the Pallas kernel (in interpret
mode) with a residual, with a stride, and with K off the wg body's 64-wide
stages.

Tolerance: rtol = atol = 2e-5 in fp32, as tests/test_pallas_kernels.py:23
holds the Pallas kernel to its reference."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipbert_tpu.ops import pallas_kernels as j_pk
from clipbert_tpu_torch.models import resnet
from clipbert_tpu_torch.ops import matmul_bn_act as mba

SRC = (Path(mba.__file__).resolve().parents[1] / "csrc"
       / "matmul_bn_act.cu").read_text()
BF16, FP32 = torch.bfloat16, torch.float32
N_SMS = 132                                 # an H100 SXM
GEMM_TOL = dict(rtol=2e-5, atol=2e-5)


def _r50_1x1(frames=32, img=448):
    """{(R, K, N, stride, in_hw, out_hw, residual): launches per encode}
    of ResNet-50's fused 1x1 convs (conv1, the shortcut and conv3 of each
    stage's first bottleneck, conv1 of the others; the stride on the 1x1
    reduce conv)."""
    shapes, cin, hw = {}, 64, img // 4
    for si, (n, cmid, cout) in enumerate(resnet.R50_STAGES):
        s = 1 if si == 0 else 2
        out = hw // s
        for K, N, stride, in_hw, res, count in (
                (cin, cmid, s, hw, False, 1), (cin, cout, s, hw, False, 1),
                (cmid, cout, 1, out, True, n),
                (cout, cmid, 1, out, False, n - 1)):
            key = (frames * out * out, K, N, stride, in_hw, out, res)
            shapes[key] = shapes.get(key, 0) + count
        cin, hw = cout, out
    return shapes


R50 = _r50_1x1()


def _cu_int(name: str) -> int:
    """The value of the namespace-level ``constexpr int name = <expr>;`` in
    the source, with the source's earlier constants in scope."""
    env = {}
    for m in re.finditer(r"^constexpr int ([^;]+);", SRC, re.M):
        for part in m.group(1).split(","):
            k, v = (t.strip() for t in part.split("="))
            env[k] = eval(v, {}, env)
    return env[name]


def test_the_r50_shapes():
    assert len(R50) == 16
    assert sum(R50.values()) == 36           # chip_smoke's MBA_PER_ENCODE
    assert sum(s > 1 for (_, _, _, s, _, _, _) in R50) == 6


@pytest.mark.parametrize("R,K,N,stride,in_hw,out_hw,residual", list(R50))
def test_plan_runs_every_r50_shape_on_the_wg_body(R, K, N, stride, in_hw,
                                                  out_hw, residual):
    plan = mba._plan(R, K, N, stride, in_hw, in_hw, out_hw, BF16, True,
                     N_SMS)
    assert plan.body == "wg"
    assert plan.tile_n == (64 if N == 64 else 128)      # N = 64 pads nothing
    assert plan.threads == 384
    if stride == 1:
        tiles = -(-R // 128) * -(-N // plan.tile_n)
    else:                   # whole output rows: 2 of 56, 4 of 28, 9 of 14
        rows = 128 // out_hw
        assert rows * out_hw in (112, 126)
        tiles = -(-(R // out_hw) // rows) * -(-N // plan.tile_n)
    assert plan.grid == min(N_SMS, tiles)
    assert plan.grid == N_SMS                  # every shape fills the card


# the plans the wg body's rule gave before it took 256-wide tiles, which it
# keeps at every R50 shape: BN 64 at N = 64, else 128, one block per SM
R50_PLANS = {64: mba.Plan("wg", N_SMS, 384, 214272, 64, 6),
             128: mba.Plan("wg", N_SMS, 384, 230656, 128, 5)}


@pytest.mark.parametrize("R,K,N,stride,in_hw,out_hw,residual", list(R50))
def test_r50_plans_are_unchanged(R, K, N, stride, in_hw, out_hw, residual):
    plan = mba._plan(R, K, N, stride, in_hw, in_hw, out_hw, BF16, True,
                     N_SMS)
    assert plan == R50_PLANS[64 if N == 64 else 128]


@pytest.mark.parametrize("R,K,N,tile_n", [
    (565248, 768, 2304, 256), (565248, 768, 768, 256),
    (565248, 768, 3072, 256), (565248, 3072, 768, 128),
    (5248, 768, 2304, 128), (5248, 768, 768, 128), (5248, 768, 3072, 128),
    (5248, 3072, 768, 128)])
def test_plan_at_bert_shapes(R, K, N, tile_n):
    """BERT's four products a layer (QKV, attention output, FFN up, FFN
    down) at the retrieval eval's 8192 x 69 rows and VQA's 32 x 164: 256
    wide where K = 768 and the tiles fill the card 8 times over."""
    plan = mba._plan(R, K, N, 1, R, 1, 1, BF16, True, N_SMS)
    assert (plan.body, plan.tile_n, plan.grid) == ("wg", tile_n, N_SMS)
    assert plan.stages == mba._wg_stages(tile_n)


@pytest.mark.parametrize("R,K,N,stride,in_hw,out_hw,dtype,aligned,why", [
    (401408, 64, 256, 1, 112, 112, FP32, True,
     "fp32 keeps the CUDA-core products"),
    (1000, 12, 64, 1, 10, 10, BF16, True, "K not a multiple of 8"),
    (1000, 64, 60, 1, 10, 10, BF16, True, "N not a multiple of 8"),
    (1000, 64, 64, 1, 10, 10, BF16, False, "a base off 16 bytes"),
    (25, 64, 64, 2, 9, 5, BF16, True, "a stride that does not divide H"),
    (260, 64, 64, 2, 260, 130, BF16, True,
     "output rows wider than a tile"),
])
def test_plan_keeps_mma(R, K, N, stride, in_hw, out_hw, dtype, aligned, why):
    plan = mba._plan(R, K, N, stride, in_hw, in_hw, out_hw, dtype, aligned,
                     N_SMS)
    assert plan == mba.Plan("mma", -(-R // 128) * -(-N // 128), 256, 0, 128,
                            1), why


@pytest.mark.parametrize("tile_n,stages,smem", [(64, 6, 214272),
                                                 (128, 5, 230656),
                                                 (256, 3, 214272)])
def test_wg_plan_matches_the_source_formulas(tile_n, stages, smem):
    """The ring gets what a block's 227 KB leave after the alignment slack,
    the barriers and the epilogue's 4 slots of 128 x 64 bf16, in stages of
    a 128 x 64 A box and a BN x 64 B box, at most 8."""
    room = (_cu_int("kSmemBudget") - _cu_int("kAlign")
            - _cu_int("kBarrierBytes")
            - _cu_int("kEpiSlots") * _cu_int("kSubBytes"))
    stage = (_cu_int("kBM") + tile_n) * _cu_int("kBK") * 2
    want = min(room // stage, _cu_int("kMaxStages"))
    assert mba._wg_stages(tile_n) == want == stages
    assert mba._wg_smem_bytes(tile_n) == smem == (
        _cu_int("kAlign") + stages * stage
        + _cu_int("kEpiSlots") * _cu_int("kSubBytes")
        + _cu_int("kBarrierBytes"))
    assert smem <= _cu_int("kSmemBudget")
    plan = mba._plan(5000, 64, 256, 1, 50, 100, 100, BF16, True, N_SMS,
                     tile_n=tile_n)
    assert (plan.stages, plan.smem_bytes) == (stages, smem)
    # the source computes the same
    assert re.search(r"kStageRoom =\s+kSmemBudget - kAlign - kBarrierBytes "
                     r"- kEpiSlots \* kSubBytes;", SRC)
    assert re.search(r"return \(kBM \+ bn\) \* kBK \* 2;", SRC)
    assert re.search(r"return kAlign \+ wg_stages\(bn\) \* wg_stage_bytes"
                     r"\(bn\) \+ kEpiSlots \* kSubBytes \+\s+kBarrierBytes;",
                     SRC)


def test_plan_constants_are_the_sources():
    assert mba._WG_BM == _cu_int("kBM") == 128
    assert mba._WG_BK == _cu_int("kBK") == 64
    assert mba._WG_SUB_N == _cu_int("kSubN")
    assert _cu_int("kSubBytes") == mba._WG_BM * mba._WG_SUB_N * 2
    assert mba._WG_EPI_SLOTS == _cu_int("kEpiSlots")
    assert mba._WG_MAX_STAGES == _cu_int("kMaxStages")
    assert mba._WG_SMEM_BUDGET == _cu_int("kSmemBudget") == 227 * 1024
    assert mba._WG_ALIGN == _cu_int("kAlign")
    assert mba._WG_BARRIER_BYTES == _cu_int("kBarrierBytes")
    assert mba._WG_THREADS == _cu_int("kWgThreads") == 3 * 128
    assert mba._MMA_TILE == _cu_int("BM") == _cu_int("BN")
    assert mba._MMA_THREADS == _cu_int("kThreads")
    assert mba._PLAN_MISMATCH == _cu_int("kPlanMismatch")
    assert mba._TENSOR_MAP_FAILED == _cu_int("kTensorMapFailed")
    assert mba._BODY_CODES == {"mma": _cu_int("kBodyMma"),
                               "wg": _cu_int("kBodyWg")}
    # the tile widths the entry point takes and instantiates
    assert re.search(r"tile_n != 64 && tile_n != 128 && tile_n != 256", SRC)
    cases = re.findall(r"return launch_wg<(\d+)>", SRC)
    assert tuple(sorted(int(c) for c in cases)) == mba.WG_TILE_NS
    # the default width and what TMA takes
    assert (mba._WG_WIDE_MIN_N, mba._WG_WIDE_MIN_K, mba._WG_WIDE_MAX_K,
            mba._WG_WIDE_WAVES) == (_cu_int("kWideMinN"),
                                    _cu_int("kWideMinK"),
                                    _cu_int("kWideMaxK"),
                                    _cu_int("kWideWaves"))
    body = re.search(r"int wg_tile_n\(long long R, int K, int N, int n_sms\) "
                     r"\{(.*?)\n\}", SRC, re.S).group(1)
    assert "if (N <= 64) return 64;" in body
    assert re.search(r"wide_tiles = \(\(R \+ kBM - 1\) / kBM\) \* "
                     r"\(\(N \+ 255\) / 256\);", body)
    assert re.search(r"N >= kWideMinN && K >= kWideMinK && K <= kWideMaxK &&"
                     r"\s+wide_tiles >= static_cast<long long>\(kWideWaves\) "
                     r"\* n_sms\s+\? 256\s+: 128;", body)
    assert re.search(r"tile_n != wg_tile_n\(R, K, N, n_sms\)", SRC)
    assert [mba._wg_tile_n(10 ** 6, 768, n, N_SMS)
            for n in (8, 64, 72, 128, 2048)] == [64, 64, 128, 128, 256]
    assert re.search(r"K % 8 == 0 && N % 8 == 0", SRC)
    assert re.search(r"in_h % stride == 0 && in_w % stride == 0 && "
                     r"out_w <= kBM", SRC)


def test_argtypes_match_the_c_signature():
    sig = re.search(r'extern "C" int clipbert_matmul_bn_act\((.*?)\)',
                    SRC, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").split()
        want.append(ctype[" ".join(words[:-1])])
    assert mba._ARGTYPES == want


@pytest.mark.parametrize("body,tile_n,dtype,want", [
    ("mma", None, BF16, ("mma", 128, 1)), ("mma", None, FP32, ("mma", 128, 1)),
    ("wg", None, BF16, ("wg", 128, 5)), (None, 64, BF16, ("wg", 64, 6)),
    ("wg", 256, BF16, ("wg", 256, 3))])
def test_forced_body_and_tile(body, tile_n, dtype, want):
    plan = mba._plan(4096, 256, 512, 1, 64, 64, 64, dtype, True, N_SMS, body,
                     tile_n)
    assert (plan.body, plan.tile_n, plan.stages) == want


@pytest.mark.parametrize("body,tile_n,dtype,K", [
    ("wg", None, FP32, 256), ("wg", None, BF16, 12), (None, 96, BF16, 256),
    ("mma", 64, BF16, 256), ("wgmma", None, BF16, 256)])
def test_forced_body_the_kernel_does_not_have(body, tile_n, dtype, K):
    with pytest.raises(ValueError):
        mba._plan(4096, K, 512, 1, 64, 64, 64, dtype, True, N_SMS, body,
                  tile_n)


def test_aligned16():
    x = torch.zeros(64, 8, dtype=BF16)
    assert mba._aligned16(x, None)
    assert not mba._aligned16(torch.zeros(513, dtype=BF16)[1:].view(64, 8))
    assert not mba._aligned16(x, torch.zeros(65, dtype=BF16)[1:])


@pytest.mark.parametrize("dtype,residual,stride", [
    (BF16, True, 1), (BF16, False, 2), (FP32, True, 1), (FP32, False, 2)])
def test_cpu_tensors_take_the_plain_version(rng_np, dtype, residual, stride):
    x = torch.from_numpy(rng_np.standard_normal((2, 8, 6, 64))
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng_np.standard_normal((128, 64, 1, 1)) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rng_np.standard_normal(128).astype(np.float32))
    Ho, Wo = 8 // stride, 6 // stride
    r = torch.from_numpy(rng_np.standard_normal((2, Ho, Wo, 128))
                         .astype(np.float32)).to(dtype) if residual else None
    counts = (mba.LAUNCHES, mba.WG_LAUNCHES)
    got = mba.conv1x1_bn_act(x, w, None, b, stride, r)
    got2d = mba.matmul_bn_act(x.reshape(-1, 64), w.reshape(128, 64).t(),
                              None, b, None)
    assert (mba.LAUNCHES, mba.WG_LAUNCHES) == counts
    want = mba.matmul_bn_act_reference(
        x[:, ::stride, ::stride].reshape(-1, 64), w.reshape(128, 64).t(),
        None, b, None if r is None else r.reshape(-1, 128))
    assert got.dtype == dtype and tuple(got.shape) == (2, Ho, Wo, 128)
    torch.testing.assert_close(got.reshape(-1, 128), want, rtol=0, atol=0)
    torch.testing.assert_close(
        got2d, mba.matmul_bn_act_reference(x.reshape(-1, 64),
                                           w.reshape(128, 64).t(), None, b),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", ["residual", "strided", "ragged K"])
def test_reference_matches_pallas(rng_np, case):
    """The plain version against the Pallas kernel (interpret mode on the
    CPU): with a residual at ResNet's conv3 pattern, a strided conv whose
    output rows the wg body tiles whole, and K = 72, which leaves the wg
    body's second 64-wide stage 8 columns deep."""
    B, H, W, K, N = {"residual": (2, 6, 7, 64, 96),
                     "strided": (2, 8, 14, 64, 40),
                     "ragged K": (1, 9, 11, 72, 64)}[case]
    stride = 2 if case == "strided" else 1
    x = rng_np.standard_normal((B, H, W, K)).astype(np.float32)
    k = (rng_np.standard_normal((1, 1, K, N)) * K ** -0.5).astype(np.float32)
    s = (0.5 + rng_np.random(N)).astype(np.float32)
    b = rng_np.standard_normal(N).astype(np.float32)
    Ho, Wo = H // stride, W // stride
    r = (rng_np.standard_normal((B, Ho, Wo, N)).astype(np.float32)
         if case == "residual" else None)
    want = j_pk.conv1x1_bn_act(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(s), jnp.asarray(b), stride=stride,
                               residual=None if r is None else jnp.asarray(r),
                               relu=case != "strided")
    t = torch.from_numpy
    got = mba.conv1x1_bn_act(t(x), t(k.transpose(3, 2, 0, 1).copy()), t(s),
                             t(b), stride=stride,
                             residual=None if r is None else t(r),
                             relu=case != "strided")
    assert tuple(got.shape) == (B, Ho, Wo, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    # the wg body takes each of these shapes in bf16
    assert mba._plan(B * Ho * Wo, K, N, stride, H, W, Wo, BF16, True,
                     N_SMS).body == "wg"
