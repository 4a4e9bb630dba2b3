"""Parity of the port's ops (clipbert_tpu_torch/ops) with the JAX package's,
on the CPU. Inputs come from numpy; JAX runs on the CPU, where its Pallas
attention kernel runs in interpret mode (pallas_attention.py:110).

Tolerance: rtol = atol = 1e-5 in fp32, as tests/test_pallas_kernels.py:112
holds the Pallas kernel to the einsum path: both sides sum in fp32 in
different orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipbert_tpu.models.bert import extended_attention_mask
from clipbert_tpu.ops import activations as j_act
from clipbert_tpu.ops.linear import linear as j_linear
from clipbert_tpu.ops.attention import multi_head_attention as j_mha
from clipbert_tpu.ops.layernorm import layer_norm as j_layer_norm
from clipbert_tpu.ops.pallas_attention import BLK_B
from clipbert_tpu.ops.pallas_attention import fused_attention as j_fused
from clipbert_tpu_torch.ops import fused_attention as fa
from clipbert_tpu_torch.ops.activations import ACT2FN, gelu
from clipbert_tpu_torch.ops.attention import SelfAttention, multi_head_attention
from clipbert_tpu_torch.ops.layernorm import layer_norm
from clipbert_tpu_torch.ops.linear import dense

TOL = dict(rtol=1e-5, atol=1e-5)
# the ragged (B, L) cases of tests/test_pallas_kernels.py:105
SHAPES = [(3, 11), (BLK_B, 16), (2 * BLK_B + 1, 7)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm_matches_jax(rng_np, eps):
    x = rng_np.standard_normal((4, 7, 32)).astype(np.float32) * 3 + 1
    s = rng_np.standard_normal(32).astype(np.float32)
    b = rng_np.standard_normal(32).astype(np.float32)
    want = np.asarray(j_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b), eps))
    got = layer_norm(_t(x), _t(s), _t(b), eps).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_linear_matches_jax_fp32(rng_np):
    x = rng_np.standard_normal((5, 3, 32)).astype(np.float32)
    k = rng_np.standard_normal((32, 48)).astype(np.float32) * 0.1
    b = rng_np.standard_normal(48).astype(np.float32)
    want = np.asarray(j_linear(jnp.asarray(x), {
        "kernel": jnp.asarray(k), "bias": jnp.asarray(b)}))
    got = dense(_t(x), _t(k.T), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_linear_matches_jax_bf16(rng_np):
    """bf16 operands, fp32 accumulation and bias, one cast: both sides
    round once from nearly equal fp32 sums, so they agree to one bf16
    ulp (2**-8 relative)."""
    x = rng_np.standard_normal((6, 64)).astype(np.float32)
    k = rng_np.standard_normal((64, 16)).astype(np.float32) * 0.1
    b = rng_np.standard_normal(16).astype(np.float32)
    want = np.asarray(j_linear(
        jnp.asarray(x, jnp.bfloat16),
        {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)})
    ).astype(np.float32)
    got = dense(_t(x).bfloat16(), _t(k.T), _t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)


def test_gelu_matches_jax(rng_np):
    x = rng_np.standard_normal((3, 50)).astype(np.float32) * 3
    want = np.asarray(j_act.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(_t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["swish", "mish", "gelu_new", "relu"])
def test_activations_match_jax(rng_np, name):
    """Every entry of ACT2FN, the JAX package's names and functions."""
    assert set(ACT2FN) == set(j_act.ACT2FN)
    x = rng_np.standard_normal((3, 50)).astype(np.float32) * 4
    want = np.asarray(j_act.ACT2FN[name](jnp.asarray(x)))
    np.testing.assert_allclose(ACT2FN[name](_t(x)).numpy(), want, **TOL)


def _qkv_bias(rng_np, B, S, H=4, dh=8):
    q, k, v = (rng_np.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    mask = (rng_np.random((B, S)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0                    # never mask key 0
    return q, k, v, ((1.0 - mask) * -10000.0).astype(np.float32)


@pytest.mark.parametrize("B,S", SHAPES)
def test_fused_attention_reference_matches_pallas_interpret(rng_np, B, S):
    q, k, v, bias = _qkv_bias(rng_np, B, S)
    scale = 1.0 / 8 ** 0.5
    want = np.asarray(j_fused(*(jnp.asarray(a) for a in (q, k, v, bias)),
                              scale))
    got = fa.fused_attention_reference(_t(q), _t(k), _t(v), _t(bias), scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper routes CPU tensors to the plain version
    launches = fa.LAUNCHES
    wrapped = fa.fused_attention(_t(q), _t(k), _t(v), _t(bias), scale)
    assert fa.LAUNCHES == launches
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,L", SHAPES)
def test_multi_head_attention_matches_jax(rng_np, B, L, fused):
    """Port einsum path and port fused route (plain version on the CPU)
    against both JAX paths: einsum and the Pallas kernel."""
    D, H = 32, 4
    params = {n: {"kernel": rng_np.standard_normal((D, D)).astype(np.float32)
                  * 0.1,
                  "bias": rng_np.standard_normal(D).astype(np.float32) * 0.1}
              for n in ("query", "key", "value")}
    hidden = rng_np.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng_np.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    jbias = extended_attention_mask(jnp.asarray(mask))
    jp = {n: {kk: jnp.asarray(a) for kk, a in d.items()}
          for n, d in params.items()}
    want_einsum = np.asarray(j_mha(jnp.asarray(hidden), jp, H, jbias,
                                   fused=False))
    want_pallas = np.asarray(j_mha(jnp.asarray(hidden), jp, H, jbias,
                                   fused=True))

    attn = SelfAttention(D)
    with torch.no_grad():
        for n in ("query", "key", "value"):
            getattr(attn, n).weight.copy_(_t(params[n]["kernel"].T))
            getattr(attn, n).bias.copy_(_t(params[n]["bias"]))
    tbias = ((1.0 - _t(mask)) * -10000.0)[:, None, None, :]
    with torch.no_grad():
        got = multi_head_attention(_t(hidden), attn, H, tbias,
                                   fused=fused).numpy()
    np.testing.assert_allclose(got, want_einsum, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("case", ["shape", "bias", "dtype", "head_dim",
                                  "seq", "stride", "device"])
def test_fused_attention_rejects_what_the_kernel_does_not_take(case):
    B, S, H, dh = 2, 5, 2, 8
    q = k = v = torch.zeros(B, S, H, dh)
    bias = torch.zeros(B, S)
    if case == "shape":
        k = torch.zeros(B, S + 1, H, dh)
    elif case == "bias":
        bias = torch.zeros(B, S + 1)
    elif case == "dtype":
        q = k = v = torch.zeros(B, S, H, dh, dtype=torch.float16)
    elif case == "head_dim":
        q = k = v = torch.zeros(B, S, H, 12)
    elif case == "seq":
        q = k = v = torch.zeros(B, fa.MAX_SEQ + 1, H, dh)
        bias = torch.zeros(B, fa.MAX_SEQ + 1)
    elif case == "stride":
        q = torch.zeros(B, S, H, 2 * dh)[..., ::2]
    elif case == "device":
        bias = torch.zeros(B, S, device="meta")
    with pytest.raises(ValueError):
        fa.fused_attention(q, k, v, bias, 0.5)
