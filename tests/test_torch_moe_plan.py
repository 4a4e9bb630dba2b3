"""The grouped expert GEMM's launch plan and row layout (clipbert_tpu_torch/
ops/moe.py), on the CPU.

The kernel (csrc/matmul_bn_act.cu, moe_grouped_gemm_wg_kernel) builds and
runs only on the card. Here: the tile plan it derives (the wg body's
tile width, stages and shared memory, one persistent block per SM), the
C signature the wrapper binds, the padded row bound and the tile walk's
arithmetic: which rows a live tile covers and that dead tiles are left
alone."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from clipbert_tpu_torch.ops import matmul_bn_act as mba
from clipbert_tpu_torch.ops import moe
from clipbert_tpu_torch.ops.linear import dense_reference

SRC = (Path(mba.__file__).resolve().parents[1] / "csrc"
       / "matmul_bn_act.cu").read_text()

# the Kimi-VL retrieval dispatch: 2048 sequences of 69 tokens, 6 of 64
# experts each, D 2048, expert width 1408
T, K_TOP, E, D, I = 2048 * 69, 6, 64, 2048, 1408


def tile_walk(x, w, tile_expert, live_m, pairs):
    """The grouped kernel's tile walk in plain PyTorch, with
    ``_grouped_launch``'s arguments: row tile m < live_m of x (rows, K)
    times expert tile_expert[m]'s (N, K) weight, fp32 sums, one rounding
    to x's dtype; rows of the dead tiles stay zero (the kernel leaves
    them unwritten)."""
    out = torch.zeros(x.shape[0], w.shape[1], dtype=x.dtype,
                      device=x.device)
    for m in range(int(live_m[0])):
        r = slice(m * moe.ROW_TILE, (m + 1) * moe.ROW_TILE)
        out[r] = dense_reference(x[r], w[int(tile_expert[m])])
    return out


@pytest.mark.parametrize("K,N", [(D, 2 * I), (I, D)])
def test_grouped_plan_at_the_dispatch(K, N):
    rows = moe.padded_rows(T * K_TOP, E)
    assert rows == 856064 and rows % moe.ROW_TILE == 0
    plan = moe.grouped_plan(rows, K, N, 132)
    # K past 1024: 128-wide tiles, as the dense products of that depth
    assert plan == mba.Plan("wg", 132, mba._WG_THREADS,
                            mba._wg_smem_bytes(128), 128, mba._wg_stages(128))
    assert plan.tile_n == mba._wg_tile_n(rows, K, N, 132)


def test_grouped_plan_small_bound_takes_fewer_blocks():
    plan = moe.grouped_plan(256, 64, 64, 132)
    assert (plan.tile_n, plan.grid) == (64, 2)


def test_argtypes_match_the_c_signature():
    sig = re.search(r'extern "C" int clipbert_moe_grouped_gemm\((.*?)\)',
                    SRC, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    want = []
    for param in sig.split(","):
        words = param.replace("const ", "").split()
        want.append(ctype[" ".join(words[:-1])])
    assert moe._ARGTYPES == want


def test_kernel_name_is_apart_from_matmul_bn_act():
    """The grouped launch has a device name of its own, so the traced
    matmul_bn_act roofline, which matches that name, reads none of it."""
    assert "moe_grouped_gemm_wg_kernel<BN>" in SRC
    assert "matmul_bn_act" not in "moe_grouped_gemm_wg_kernel"
    assert re.search(r"wg_body<BN, true>\(tm_a, tm_b, tm_o, tm_o, a\)", SRC)
    assert re.search(r"wg_body<BN, false>\(tm_a, tm_b, tm_r, tm_o, a\)", SRC)
    assert moe.ROW_TILE == mba._WG_BM == 128


@pytest.mark.parametrize("counts", [[0, 5, 128, 129, 0, 300],
                                    [1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 256]])
def test_tile_walk_covers_each_experts_rows_once(counts):
    """Each expert's rows start on a tile boundary; every live tile lies
    inside one expert's padded run; the dead tiles past live_m are never
    computed (the plain tile walk leaves them zero)."""
    n_e = len(counts)
    idx = torch.cat([torch.full((c,), e) for e, c in enumerate(counts)])
    idx = idx[torch.randperm(len(idx), generator=torch.Generator()
                             .manual_seed(0))].reshape(-1, 1)
    plan = moe.plan_rows(idx, n_e)
    padded = [-(-c // 128) * 128 for c in counts]
    assert int(plan.live_m) == sum(padded) // 128
    assert plan.rows == moe.padded_rows(sum(counts), n_e)
    start = 0
    for e, (c, p) in enumerate(zip(counts, padded)):
        rows = plan.dest[idx == e].sort().values
        assert torch.equal(rows, start + torch.arange(c))
        for m in range(start // 128, (start + p) // 128):
            assert int(plan.tile_expert[m]) == e
        start += p
    x = torch.randn(plan.rows, 16)
    w = torch.randn(n_e, 8, 16)
    out = tile_walk(x, w, plan.tile_expert, plan.live_m, len(idx))
    live = int(plan.live_m) * 128
    assert torch.count_nonzero(out[live:]) == 0
    for e in range(n_e):
        r = plan.dest[idx == e]
        torch.testing.assert_close(out[r], x[r] @ w[e].t())
