"""Dense layer primitive (port of clipbert_tpu/ops/linear.py, fp path).

The JAX recipe: operands in the activation dtype (bf16 on the serving path),
fp32 accumulation, fp32 bias add, ONE cast back to the activation dtype.
``torch.mm``/``torch.bmm`` on bf16 CUDA tensors would round the product to
bf16 before the bias add; ``out_dtype=torch.float32`` keeps the fp32
accumulator instead. CPU builds have no such overload, so there the bf16
operands are widened to fp32 first, which gives the same numbers: a product
of two bf16 values is exact in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


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


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias with ``weight`` in nn.Linear's (out, in) layout;
    the result is in x's dtype."""
    y = mm_f32(x.reshape(-1, x.shape[-1]), weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (weight.shape[0],))


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return dense(x, layer.weight, layer.bias)


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
    the activation dtype before the reduce."""
    y = mm_f32(x.reshape(-1, x.shape[-1]), w_shard.to(x.dtype).t())
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + (w_shard.shape[0],))
