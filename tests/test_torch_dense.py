"""ops/linear.py::dense's route, on the CPU.

On a bf16 CUDA input with a bias, outside autograd, dense is one launch of
matmul_bn_act's kernel (the fp32 bias add and the one rounding in its
epilogue); ``python3 chip_smoke.py`` (phase 24) holds that launch to the
unfused formula on the card. Here: a CPU tensor still takes the unfused
formula, bit for bit, with no counter moved; and the route is exactly
CUDA, bf16, a bias, and nothing autograd tracks."""

import itertools

import numpy as np
import pytest
import torch

from clipbert_tpu_torch.ops import linear as lin

BF16, FP32 = torch.bfloat16, torch.float32
# BERT's four products a layer: QKV, attention output, FFN up, FFN down
BERT_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


def _unfused(x, weight, bias):
    """x @ weight.T in fp32, the fp32 bias, one cast to x's dtype."""
    y = x.reshape(-1, x.shape[-1]).float() @ weight.to(x.dtype).float().t()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (weight.shape[0],))


def _case(rng, case):
    """(x, weight, bias) of one case: BERT's (K, N) at 24 rows, a 3-D x, a
    non-contiguous x (every other row of a wider one), no bias."""
    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    if isinstance(case, tuple):
        K, N = case
        x = t(24, K)
    elif case == "3-D x":
        K, N = 64, 96
        x = t(2, 5, K)
    else:
        K, N = 64, 96
        x = t(10, 2 * K)[:, ::2]
    w = t(N, K, scale=K ** -0.5)
    b = None if case == "no bias" else t(N)
    return x.to(BF16), w, b


@pytest.mark.parametrize("case", BERT_KN + ["3-D x", "non-contiguous x",
                                            "no bias"], ids=str)
def test_cpu_dense_is_the_unfused_formula(rng_np, case):
    x, w, b = _case(rng_np, case)
    counts = (lin.DENSE_KERNEL_CALLS, lin.DENSE_WG_CALLS,
              lin.DENSE_PLAIN_CALLS)
    got = lin.dense(x, w, b)
    assert (lin.DENSE_KERNEL_CALLS, lin.DENSE_WG_CALLS,
            lin.DENSE_PLAIN_CALLS) == counts       # CPU calls count nothing
    want = _unfused(x, w, b)
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(lin.dense_reference(x, w, b), want)


@pytest.mark.parametrize(
    "on_cuda,dtype,has_bias,tracked",
    list(itertools.product((True, False), (BF16, FP32, torch.float16),
                           (True, False), (True, False))))
def test_route_is_cuda_bf16_bias_untracked(on_cuda, dtype, has_bias,
                                           tracked):
    # a bias no longer has a say: the kernel's epilogue adds one where
    # there is one (the deepseek_v3 encoder's products have none)
    want = on_cuda and dtype == BF16 and not tracked
    assert lin.routes_to_kernel(on_cuda, dtype, has_bias, tracked) is want
