"""Dense layer primitive (port of clipbert_tpu/ops/linear.py), the int8
scoring path, and the autograd form of the Megatron split's collectives.

The JAX recipe: operands in the activation dtype (bf16 on the serving path),
fp32 accumulation, fp32 bias add, ONE cast back to the activation dtype.
``torch.mm``/``torch.bmm`` on bf16 CUDA tensors would round the product to
bf16 before the bias add; ``out_dtype=torch.float32`` keeps the fp32
accumulator instead. CPU builds have no such overload, so there the bf16
operands are widened to fp32 first, which gives the same numbers: a product
of two bf16 values is exact in fp32.

:func:`dense` on a bf16 CUDA input outside autograd (every eval, scoring
and serving forward), with or without a bias, is one launch of the
hand-written GEMM (ops/matmul_bn_act.py, body wg): the fp32 accumulators
get the fp32 bias, where there is one, and one rounding to bf16 in its
epilogue, so the fp32 (R, N) product is never written. That is where XLA
puts the JAX package's bias add and cast. Every other input takes
:func:`dense_reference`, the unfused formula: the CPU (the numbers the JAX
parity tests hold), fp32, and the train steps' forward under autograd (the
kernel has no backward).

int8 path (opt-in, inference scoring only): :func:`quantize_dense` turns
an ``nn.Linear`` into a :class:`QuantLinear` (symmetric per-output-channel
int8 weights), and :func:`linear` dispatches on it: activations are
quantized per token (abs-max over the features), the product runs int8 x
int8 -> int32 through ``torch._int_mm`` (:func:`int_mm`), and the result
is dequantized by row scale x column scale in fp32, the JAX expression's
order.

Tensor parallelism (parallel/sharding.py): :func:`copy_to_model_group`
and :func:`reduce_from_model_group` are Megatron's *f* and *g*, explicit
``torch.autograd.Function``s, so the tensor-parallel train step's
gradients are the whole model's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from clipbert_tpu_torch.ops import matmul_bn_act as mba

# CUDA calls of dense since the process started (or since a caller reset
# them): those that launched matmul_bn_act's kernel, of which
# DENSE_WG_CALLS ran its wg body (the rest its mma body: K or N off a
# multiple of 8, or a row off 16-byte alignment), and those that took the
# unfused formula. CPU calls count nothing.
DENSE_KERNEL_CALLS = 0
DENSE_WG_CALLS = 0
DENSE_PLAIN_CALLS = 0


class _ProductF32(torch.autograd.Function):
    """The ``out_dtype=float32`` product on CUDA with a backward: torch
    defines none for that overload. The fp32 cotangent is rounded to the
    operands' dtype and each gradient is again one product with fp32
    accumulation, cast once to its operand's dtype (autocast's mixed
    precision; the JAX package's transpose runs the cotangent in fp32)."""

    @staticmethod
    def forward(ctx, op, a, b):
        ctx.op = op
        ctx.save_for_backward(a, b)
        return op(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        op, g = ctx.op, g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = op(g, b.transpose(-1, -2),
                    out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = op(a.transpose(-1, -2), g,
                    out_dtype=torch.float32).to(b.dtype)
        return None, ga, gb


def _f32_product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return op(a, b)
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _ProductF32.apply(op, a, b)
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> fp32 (M, N), fp32 accumulation, no rounding."""
    return _f32_product(torch.mm, a, b)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M, K) @ (N, K, P) -> fp32 (N, M, P), fp32 accumulation."""
    return _f32_product(torch.bmm, a, b)


def routes_to_kernel(on_cuda: bool, dtype: torch.dtype, has_bias: bool,
                     tracked: bool) -> bool:
    """Whether :func:`dense` launches matmul_bn_act's kernel: a bf16 CUDA
    input that autograd does not track. ``has_bias`` has no say: the
    kernel's epilogue adds a bias where there is one and nothing where
    there is none (the latent-attention and expert products)."""
    return on_cuda and dtype == torch.bfloat16 and not tracked


def dense_reference(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused :func:`dense`: the fp32 product, the fp32 bias add, one
    cast to x's dtype."""
    y = mm_f32(x.reshape(-1, x.shape[-1]), weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (weight.shape[0],))


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias with ``weight`` in nn.Linear's (out, in) layout;
    the result is in x's dtype."""
    global DENSE_KERNEL_CALLS, DENSE_WG_CALLS, DENSE_PLAIN_CALLS
    if not x.is_cuda:
        return dense_reference(x, weight, bias)
    tracked = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if not routes_to_kernel(True, x.dtype, bias is not None, tracked):
        DENSE_PLAIN_CALLS += 1
        return dense_reference(x, weight, bias)
    wg = mba.WG_LAUNCHES
    y = mba.matmul_bn_act(x.reshape(-1, x.shape[-1]), weight.t(), None,
                          bias, relu=False)
    DENSE_KERNEL_CALLS += 1
    DENSE_WG_CALLS += mba.WG_LAUNCHES - wg
    return y.reshape(x.shape[:-1] + (weight.shape[0],))


def linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``layer``'s product on ``x``: :func:`dense` for an ``nn.Linear``,
    :func:`_qlinear` for a :class:`QuantLinear`."""
    if isinstance(layer, QuantLinear):
        return _qlinear(x, layer.weight_i8, layer.kscale, layer.bias)
    return dense(x, layer.weight, layer.bias)


# ---------------------------------------------------------------------------
# int8 scoring (clipbert_tpu/ops/linear.py:28-73)
# ---------------------------------------------------------------------------

_QMAX = 127.0
# torch._int_mm's shape rules on CUDA (aten/src/ATen/native/cuda/Blas.cpp,
# _int_mm_out_cuda): more than 16 rows, K and N positive multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


class QuantLinear(nn.Module):
    """An ``nn.Linear`` quantized for scoring: ``weight_i8`` (out, in)
    int8, ``kscale`` (out,) fp32 per-output-channel scales, and the
    floating ``bias``; all buffers (nothing trains)."""

    def __init__(self, weight_i8: torch.Tensor, kscale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight_i8", weight_i8)
        self.register_buffer("kscale", kscale)
        self.register_buffer("bias", bias)


@torch.no_grad()
def quantize_dense(layer: nn.Module) -> nn.Module:
    """nn.Linear -> :class:`QuantLinear`: symmetric per-output-channel
    scales over the contraction (``in``, dim 1 of the (out, in) weight),
    ``max|w| / 127`` floored at 1e-12, then round half to even and clip
    to +-127. The JAX quantize_dense on the (in, out) kernel, transposed.
    Idempotent: a QuantLinear passes through."""
    if isinstance(layer, QuantLinear):
        return layer
    w = layer.weight.detach().float()
    s = torch.clamp(w.abs().amax(dim=1, keepdim=True) / _QMAX, min=1e-12)
    wi = torch.clamp(torch.round(w / s), -_QMAX, _QMAX).to(torch.int8)
    bias = None if layer.bias is None else layer.bias.detach().clone()
    return QuantLinear(wi, s[:, 0].contiguous(), bias)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 weights, transposed -> (M, N) int32, one
    ``torch._int_mm``. A shape outside its CUDA rules is zero-padded up to
    them (rows to 17, K and N to multiples of 8) and the result sliced
    back: integer sums are exact, so no kept element changes. The same
    padding runs on every device."""
    M, K = a.shape
    N = w.shape[0]
    Mp = max(M, _INT_MM_MIN_ROWS)
    Kp, Np = _round_up(K, _INT_MM_ALIGN), _round_up(N, _INT_MM_ALIGN)
    if (Mp, Kp, Np) != (M, K, N):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
        w = torch.nn.functional.pad(w, (0, Kp - K, 0, Np - N))
    return torch._int_mm(a.contiguous(), w.t())[:M, :N]


def _qlinear(x: torch.Tensor, weight_i8: torch.Tensor, kscale: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-token abs-max activation scales, int8 x int8 -> int32, then
    ``acc * rs * kscale`` in fp32 in that order, the fp32 bias, one cast to
    x's dtype (clipbert_tpu/ops/linear.py::_qlinear)."""
    xf = x.float().reshape(-1, x.shape[-1])
    rs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / _QMAX, min=1e-12)
    xi = torch.clamp(torch.round(xf / rs), -_QMAX, _QMAX).to(torch.int8)
    y = int_mm(xi, weight_i8).float() * rs * kscale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (weight_i8.shape[0],))


# ---------------------------------------------------------------------------
# the Megatron split's collectives, with their gradients
# ---------------------------------------------------------------------------

class _CopyToModelGroup(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the input gradient
    all-reduced (SUM) over the model group, since each rank's
    column-parallel product gives only its shard's share of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromModelGroup(torch.autograd.Function):
    """Megatron's g: the partial products all-reduced (SUM) over the model
    group forward; the identity backward, since every model rank computes
    the same loss from the replicated result. (An all-reduce of the
    gradient here would scale it by the model axis.)"""

    @staticmethod
    def forward(ctx, y, group):
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_group(x: torch.Tensor,
                        group: dist.ProcessGroup) -> torch.Tensor:
    """The input of a column-parallel product (q/k/v, the FFN up
    projection): unchanged forward, gradient summed over ``group``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModelGroup.apply(x, group)
    return x


def reduce_from_model_group(y: torch.Tensor,
                            group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of every model rank's ``y``; its gradient passes through
    unchanged."""
    if torch.is_grad_enabled() and y.requires_grad:
        return _ReduceFromModelGroup.apply(y, group)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def dense_row_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                       bias: Optional[torch.Tensor],
                       group: dist.ProcessGroup) -> torch.Tensor:
    """The row-parallel product of the Megatron split
    (parallel/sharding.py): ``x`` holds this rank's slice of the input
    features and ``w_shard`` the matching (out, in / n) columns of the
    weight. The fp32 partial product is all-reduced (SUM) in fp32 over the
    model ``group``, then the whole fp32 bias is added once and the result
    cast once to x's dtype: what GSPMD computes for the JAX package's
    row-split ``dot(preferred_element_type=f32)``. Nothing is rounded to
    the activation dtype before the reduce. Under autograd the reduce is
    :func:`reduce_from_model_group`: its gradient passes through."""
    y = mm_f32(x.reshape(-1, x.shape[-1]), w_shard.to(x.dtype).t())
    y = reduce_from_model_group(y, group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (w_shard.shape[0],))
