"""The fused-attention kernel's launch plan (clipbert_tpu_torch/ops/
fused_attention.py::_plan) and its binding, on the CPU.

The kernel itself (csrc/fused_attention.cu) builds and runs only on the
card, where ``python3 chip_smoke.py`` holds both of its bodies against the
plain version. Here: which body the plan picks for each shape and dtype
(the tensor-core body at every joint length the configs and the QA
family's shapes give), the plan's grid, warps and shared-memory bytes
against the formulas of the source note, that the constants and the C
signature the wrapper relies on are the source's, that a CPU tensor still
takes the plain version with no counter moved, and that the plain version
matches the Pallas kernel (in interpret mode) when S is not a multiple of
the tensor-core body's 16-row tiles and the last keys are masked, up to
the QA family's S = 149-174.

Tolerance: rtol = atol = 1e-5 in fp32, as tests/test_pallas_kernels.py:112
holds the Pallas kernel to the einsum path."""

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from clipbert_tpu.ops.pallas_attention import fused_attention as j_fused
from clipbert_tpu_torch.ops import fused_attention as fa

SRC = (Path(fa.__file__).resolve().parents[1] / "csrc"
       / "fused_attention.cu").read_text()
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
BF16, FP32 = torch.bfloat16, torch.float32

# (B, S, H, dh) of the main path: serving at 1 and 16 clips x 32 captions,
# the eval dispatch, one rank's head shard under a 2-way model axis; the
# QA family's shapes (chip_smoke.QA_ATTN_SHAPES) join them in the test
MAIN_PATH = [(32, 69, 12, 64), (512, 69, 12, 64), (8192, 69, 12, 64),
             (128, 69, 6, 64)]


def _cu_int(name: str) -> int:
    """The value of ``constexpr int name = <expr>;`` in the source."""
    m = re.search(rf"constexpr int [^;]*\b{name} = ([^,;]+)[,;]", SRC)
    return int(eval(m.group(1), {}, {}))


def _merged_qkv_views(B, S, H, dh, dtype):
    """q, k, v as the strided views of one merged QKV projection (row pitch
    3 H dh), as ops/attention.py hands them to the kernel."""
    qkv = torch.zeros(B, S, 3 * H * dh, dtype=dtype)
    return tuple(t.view(B, S, H, dh) for t in qkv.split(H * dh, dim=-1))


@pytest.mark.parametrize("B,S,H,dh", MAIN_PATH + [
    shape[:4] for shape in chip_smoke.QA_ATTN_SHAPES])
def test_plan_runs_the_main_path_on_the_tensor_core_body(B, S, H, dh):
    q, k, v = _merged_qkv_views(B, S, H, dh, BF16)
    assert q.stride(1) == 3 * H * dh            # 2304, or 1152 for a shard
    assert fa._aligned16(q, k, v)
    plan = fa._plan(B, S, H, dh, BF16, fa._aligned16(q, k, v))
    assert plan.body == "tc" and plan.vec


@pytest.mark.parametrize("B,S,H,dh,dtype,why", [
    (512, 69, 12, 64, FP32, "fp32 needs exact fp32 products"),
    (2, 620, 12, 64, BF16, "longest sequence"),
    (3, 177, 2, 64, BF16, "just past the register-resident limit"),
    (3, 11, 4, 8, BF16, "dh 8, the ragged shapes"),
    (2, 69, 2, 72, BF16, "dh not a multiple of 16"),
])
def test_plan_keeps_v2(B, S, H, dh, dtype, why):
    assert fa._plan(B, S, H, dh, dtype, True).body == "v2", why


@pytest.mark.parametrize("S,dh,splits,warps", [
    (1, 16, 1, 1), (16, 32, 1, 1), (17, 48, 1, 2), (69, 64, 1, 5),
    (100, 96, 2, 4), (128, 128, 2, 4), (129, 64, 2, 5), (149, 64, 2, 5),
    (164, 64, 2, 6), (169, 64, 2, 6), (174, 64, 2, 6), (176, 128, 2, 6)])
def test_tc_plan_matches_the_source_formulas(S, dh, splits, warps):
    """One warp per 16 query rows; a (batch item, head)'s KT = ceil(S / 16)
    query tiles split over ceil(KT / kTcBlockWarps) blocks of as few warps
    as hold them; each block holds K and V as bf16 rows of dh + 8 elements
    and the key bias in fp32, for 16 KT keys: 16 KT * (4 (dh + 8) + 4) =
    64 KT (dh + 9) bytes."""
    B, H = 3, 5
    plan = fa._plan(B, S, H, dh, BF16, False)
    kt = (S + 15) // 16
    assert splits * warps >= kt > (splits - 1) * warps
    assert plan == fa.Plan("tc", B * H * splits, warps,
                           64 * kt * (dh + 9), False)
    assert plan.smem_bytes <= 227 * 1024
    # the C launcher derives the same plan before it launches: K and V
    # at their own widths, 32 KT (dk + dv + 18) bytes, which is 64 KT
    # (dh + 9) at dk = dv = dh
    body = re.search(r"TcPlan plan_tc\(int S, int dk, int dv, int causal\) "
                     r"\{(.*?)\n\}", SRC, re.S).group(1)
    assert "const int KT = (S + 15) / 16;" in body
    assert ("return TcPlan{KT, dk / 16, dv / 16, causal, tc_splits(KT),\n"
            "                tc_block_threads(KT), 32 * KT * (dk + dv + 18)};"
            in body)
    assert ("return (KT + kTcBlockWarps - 1) / kTcBlockWarps;" in SRC)
    assert "return 32 * ((KT + tc_splits(KT) - 1) / tc_splits(KT));" in SRC
    assert re.search(r"blocks != \(long long\)B \* H \* p\.splits \|\| "
                     r"threads != p\.threads \|\|\s+smem != p\.smem", SRC)


@pytest.mark.parametrize("config", sorted(
    p.name for p in CONFIGS.glob("*.json")
    if "max_txt_len" in json.loads(p.read_text())))
def test_every_config_joint_length_runs_the_tensor_core_body(config):
    """S = max_txt_len + (max_img_size // 64)^2 grid tokens, at the head
    width of the config's model (768 / 12 = 64): the longest is
    pretraining's 30 + 144 = 174."""
    run = json.loads((CONFIGS / config).read_text())
    model = json.loads((CONFIGS.parent / run["model_config"]).read_text())
    S = run["max_txt_len"] + (run["max_img_size"] // 64) ** 2
    dh = model["hidden_size"] // model["num_attention_heads"]
    assert S <= fa.TC_MAX_SEQ
    assert fa._plan(2, S, model["num_attention_heads"], dh, BF16,
                    True).body == "tc"


@pytest.mark.parametrize("S,dh,rows,smem", [
    (69, 64, 9, 57936),      # one tile of 72 rows: q, score rows, all keys
    (7, 8, 1, 848),           # one tile of 8 rows
    (620, 64, 4, 203968),    # 20 tiles of 32 rows, keys in chunks of 428
])
def test_v2_plan_matches_the_source_formulas(S, dh, rows, smem):
    B, H = 2, 3
    plan = fa._plan(B, S, H, dh, FP32, True)
    q_tile = 8 * rows
    assert plan == fa.Plan("v2", B * H * -(-S // q_tile), 8, smem, True)
    assert plan.smem_bytes <= _cu_int("kSmemBytes")


def test_plan_constants_are_the_sources():
    assert fa.TC_MAX_SEQ == _cu_int("kTcMaxSeq") == 176
    assert fa.TC_BLOCK_WARPS == _cu_int("kTcBlockWarps")
    # one instantiation per 16-key tile count up to the limit
    tiles = re.findall(r"CLIPBERT_KT\((\d+)\)\n", SRC)
    assert [int(t) for t in tiles] == list(range(1, fa.TC_MAX_SEQ // 16 + 1))
    assert fa._PLAN_MISMATCH == _cu_int("kPlanMismatch")
    assert fa._BODY_CODES == {"v2": _cu_int("kBodyV2"),
                              "tc": _cu_int("kBodyTc")}
    assert fa._V2_WARPS == _cu_int("kWarps")
    assert fa._V2_SCORE_BYTES == _cu_int("kScoreBytes")
    assert fa._V2_SMEM_BYTES == _cu_int("kSmemBytes")
    assert fa.MAX_SEQ == _cu_int("kMaxSeq")
    assert fa.MAX_HEAD_DIM == _cu_int("kMaxHeadDim")
    rows = re.findall(r"CLIPBERT_ROWS\((\d+)\)\n", SRC)
    assert tuple(int(r) for r in rows) == fa._V2_ROWS


def test_argtypes_match_the_c_signature():
    sig = re.search(r'extern "C" int clipbert_fused_attention\((.*?)\)',
                    SRC, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").split()
        want.append(ctype[" ".join(words[:-1])])
    assert fa._ARGTYPES == want


@pytest.mark.parametrize("body,dtype,S,dh", [
    ("v2", BF16, 69, 64), ("v2", FP32, 69, 64), ("tc", BF16, 69, 64)])
def test_forced_body(body, dtype, S, dh):
    assert fa._plan(4, S, 2, dh, dtype, True, body).body == body


@pytest.mark.parametrize("body,dtype,S,dh", [
    ("tc", FP32, 69, 64), ("tc", BF16, 177, 64), ("tc", BF16, 11, 8),
    ("wgmma", BF16, 69, 64)])
def test_forced_body_the_kernel_does_not_have(body, dtype, S, dh):
    with pytest.raises(ValueError):
        fa._plan(4, S, 2, dh, dtype, True, body)


@pytest.mark.parametrize("layout,want", [
    ("contiguous", True), ("merged-qkv views", True),
    ("unaligned views", False), ("odd batch stride", False)])
def test_aligned16(layout, want):
    B, S, H, dh = 2, 5, 3, 16
    if layout == "contiguous":
        ts = [torch.zeros(B, S, H, dh, dtype=BF16)]
    elif layout == "merged-qkv views":
        ts = _merged_qkv_views(B, S, H, dh, BF16)
    elif layout == "unaligned views":
        ts = [torch.zeros(B, S, H, dh + 1, dtype=BF16)[..., 1:]]
    else:       # rows aligned within a batch item, batch items 8 bytes apart
        ts = [torch.zeros(B * S * H * dh + 4, dtype=BF16).as_strided(
            (B, S, H, dh), (S * H * dh + 4, H * dh, dh, 1))]
    assert fa._aligned16(*ts) is want


@pytest.mark.parametrize("B,S,H,dh,dtype", [
    (4, 69, 12, 64, BF16), (3, 20, 2, 16, BF16), (2, 69, 2, 64, FP32)])
def test_cpu_tensors_take_the_plain_version(rng_np, B, S, H, dh, dtype):
    q, k, v = (torch.from_numpy(rng_np.standard_normal((B, S, H, dh))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    bias = torch.from_numpy(((rng_np.random((B, S)) < 0.3) * -10000.0)
                            .astype(np.float32))
    counts = (fa.LAUNCHES, fa.TC_LAUNCHES, fa.SHARD_HEADS_LAUNCHES)
    got = fa.fused_attention(q, k, v, bias, dh ** -0.5)
    assert (fa.LAUNCHES, fa.TC_LAUNCHES, fa.SHARD_HEADS_LAUNCHES) == counts
    want = fa.fused_attention_reference(q, k, v, bias, dh ** -0.5)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,S,n_masked", [(3, 21, 5), (2, 69, 20),
                                          (9, 5, 1), (2, 149, 80),
                                          (2, 169, 19), (1, 174, 24)])
def test_reference_matches_pallas_with_masked_tail_keys(rng_np, B, S,
                                                        n_masked):
    """S off the 16-row tiles (the tensor-core body pads it inside the
    kernel and gives the padded keys -inf), and the last keys masked as
    padded captions are: the plain version and the Pallas kernel agree, and
    the masked keys carry no weight."""
    H, dh = 4, 16
    q, k, v = (rng_np.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, S), np.float32)
    mask[:, S - n_masked:] = 0.0
    bias = ((1.0 - mask) * -10000.0).astype(np.float32)
    scale = dh ** -0.5
    want = np.asarray(j_fused(*(jnp.asarray(a) for a in (q, k, v, bias)),
                              scale))
    got = fa.fused_attention_reference(*(torch.from_numpy(a) for a in
                                         (q, k, v, bias)), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the masked keys' values do not reach the output
    v2 = v.copy()
    v2[:, S - n_masked:] = 1e3
    got2 = fa.fused_attention_reference(*(torch.from_numpy(a) for a in
                                          (q, k, v2, bias)), scale).numpy()
    np.testing.assert_allclose(got2, got, rtol=1e-5, atol=1e-5)


# (B, S, H, dk, dv) of latent attention in the Kimi-VL retrieval dispatch
# (16 captions x 8 videos x 16 clips) and in the benchmark's check sample
MLA_PATH = [(2048, 69, 16, 192, 128), (512, 69, 16, 192, 128)]


@pytest.mark.parametrize("B,S,H,dk,dv", MLA_PATH)
def test_latent_attention_runs_the_tensor_core_body(B, S, H, dk, dv):
    """q/k 192 wide (128 + 64 RoPE), v 128 wide, causal: the tc body, K
    and V staged at their own widths, 32 * 5 * (192 + 128 + 18) = 54,080
    bytes at S = 69, which needs the opt-in above 48 KB."""
    q = torch.zeros(B, S, H, dk, dtype=BF16)
    kv = torch.zeros(B, S, H, 2 * dv, dtype=BF16)
    v = kv[..., dv:]
    assert fa._aligned16(q, q, v)
    plan = fa._plan(B, S, H, dk, BF16, fa._aligned16(q, q, v), dv=dv,
                    causal=True)
    kt = (S + 15) // 16
    assert plan == fa.Plan("tc", B * H, kt, 32 * kt * (dk + dv + 18), True)
    assert plan.smem_bytes == 54080 > 48 * 1024
    assert (fa.MLA_QK_DIM, fa.MLA_V_DIM) == (_cu_int("kMlaQkDim"),
                                             _cu_int("kMlaVDim"))


@pytest.mark.parametrize("B,S,H,dh,smem", [
    (8192, 69, 12, 64, 23360),     # msrvtt_ret.eval_1kcap's dispatch
    (32, 164, 12, 64, 51392)])     # vqa.eval_b32's batch
def test_the_benchmarked_cells_plans_are_unchanged(B, S, H, dh, smem):
    """The plans of the two BERT cells, with dv and causal at their
    defaults and given as they are."""
    kt, splits, warps = fa._tc_split(S)
    want = fa.Plan("tc", B * H * splits, warps, smem, True)
    assert fa._plan(B, S, H, dh, BF16, True) == want
    assert fa._plan(B, S, H, dh, BF16, True, dv=dh, causal=False) == want
    assert smem == 64 * kt * (dh + 9)


@pytest.mark.parametrize("dk,dv,causal,dtype", [
    (192, 64, True, BF16), (64, 64, True, BF16), (192, 128, True, FP32),
    (128, 64, False, BF16)])
def test_head_widths_no_body_takes(dk, dv, causal, dtype):
    """dk != dv outside latent attention's pair, and causal outside it or
    in fp32: no body, so the plan raises before anything launches."""
    with pytest.raises(ValueError):
        fa._plan(4, 69, 2, dk, dtype, True, dv=dv, causal=causal)


def test_causal_reference_masks_the_future():
    """The plain version with ``causal``: row i is the softmax over keys
    0..i alone, which the last query's full row agrees with."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(2, 9, 2, 192, generator=g) for _ in range(2))
    v = torch.randn(2, 9, 2, 128, generator=g)
    bias = torch.zeros(2, 9)
    out = fa.fused_attention(q, k, v, bias, 192 ** -0.5, causal=True)
    for i in (0, 4, 8):
        want = fa.fused_attention_reference(
            q[:, i:i + 1], k[:, :i + 1], v[:, :i + 1], bias[:, :i + 1],
            192 ** -0.5)
        torch.testing.assert_close(out[:, i:i + 1], want, rtol=1e-6,
                                   atol=1e-6)
