"""ResNet-50 grid-feature backbone (port of clipbert_tpu/models/resnet.py).

The reference's detectron2 GridFeatBackbone (`src/modeling/grid_feat.py:
37-105`): ResNet-50 stem -> res5 with frozen BatchNorm and res5 dilation 1,
then the ``grid_encoder`` head, conv3x3(2048 -> hidden) + 2x2 maxpool +
ReLU, giving (B, n_frm, H/64, W/64, hidden) channels-last grid features.

Public functions keep the JAX package's NHWC layout; inside, activations
are NCHW tensors in ``channels_last`` memory (an NHWC buffer viewed as
NCHW, so the permutes at the edges are free). Convolutions are
``torch.nn.functional.conv2d`` in the compute dtype, except in the kernel
form (``use_kernels``), where the stem and the 1x1 convs run the port's
hand-written CUDA kernels on NHWC buffers. Frozen BN is a
per-channel (scale, bias) buffer pair, never trained (the JAX optimizer
freezes its leaves); :func:`fold_bn_scales` folds the scale into the conv
weight for inference. Training runs the cuDNN form on unfolded BN, with
optional activation checkpointing (``remat``). Blocks are detectron2's
caffe-style bottlenecks (``stride_in_1x1=True``: the stride sits on the 1x1
reduce conv), as every config of this repo uses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from clipbert_tpu_torch.ops import kernels_default
from clipbert_tpu_torch.ops.fused_stem_pool import fused_stem_pool
from clipbert_tpu_torch.ops.matmul_bn_act import conv1x1_bn_act

# (num_blocks, bottleneck_channels, out_channels) per stage res2..res5
R50_STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


class FrozenBN(nn.Module):
    """Per-channel affine ``x * scale + bias``; ``scale`` is None once
    folded into the preceding conv (:func:`fold_bn_scales`)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))


class ConvBN(nn.Module):
    """A bias-free conv (OIHW ``weight``) followed by frozen BN."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bn = FrozenBN(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int, has_shortcut: bool):
        super().__init__()
        self.conv1 = ConvBN(cin, cmid, 1)
        self.conv2 = ConvBN(cmid, cmid, 3)
        self.conv3 = ConvBN(cmid, cout, 1)
        self.shortcut = ConvBN(cin, cout, 1) if has_shortcut else None


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn = FrozenBN(64)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = Stem()
        cin = 64
        for si, (n, cmid, cout) in enumerate(R50_STAGES):
            self.add_module(f"res{si + 2}", nn.ModuleList(
                Bottleneck(cin if bi == 0 else cout, cmid, cout, bi == 0)
                for bi in range(n)))
            cin = cout


class GridEncoder(nn.Module):
    def __init__(self, hidden_size: int, in_channels: int = 2048):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden_size, 3, padding=1,
                              bias=False)


class GridFeatBackbone(nn.Module):
    def __init__(self, hidden_size: int, in_channels: int = 2048):
        super().__init__()
        self.resnet = ResNet50()
        self.grid_encoder = GridEncoder(hidden_size, in_channels)


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW (channels_last) conv in x's dtype; accumulation is fp32 inside
    cuDNN / the CPU kernels, the output is rounded once to x's dtype."""
    w = weight.to(dtype=x.dtype, memory_format=torch.channels_last)
    return F.conv2d(x, w, None, stride, padding)


def frozen_bn(x: torch.Tensor, bn: FrozenBN) -> torch.Tensor:
    if bn.scale is not None:
        x = x * bn.scale.to(x.dtype)[None, :, None, None]
    return x + bn.bias.to(x.dtype)[None, :, None, None]


@torch.no_grad()
def fold_bn_scales(resnet: ResNet50) -> ResNet50:
    """Fold every frozen-BN scale into its conv weight, in place (weight *=
    scale per output channel; the BN keeps only its bias). Exact in real
    arithmetic; in bf16 the rounding point moves by about one ulp, so
    folded outputs are compared with folded outputs. Idempotent."""
    for m in resnet.modules():
        if isinstance(m, (ConvBN, Stem)) and m.bn.scale is not None:
            weight = m.conv.weight if isinstance(m, Stem) else m.weight
            weight.mul_(m.bn.scale[:, None, None, None])
            m.bn.scale = None
    return resnet


def bottleneck(x: torch.Tensor, p: Bottleneck, stride: int) -> torch.Tensor:
    out = torch.relu(frozen_bn(conv2d(x, p.conv1.weight, stride), p.conv1.bn))
    sc = x
    if p.shortcut is not None:
        sc = frozen_bn(conv2d(x, p.shortcut.weight, stride), p.shortcut.bn)
    out = torch.relu(frozen_bn(conv2d(out, p.conv2.weight, padding=1),
                               p.conv2.bn))
    out = frozen_bn(conv2d(out, p.conv3.weight), p.conv3.bn)
    return torch.relu(out + sc)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """NCHW max pool; padding counts as -inf."""
    return F.max_pool2d(x, window, stride, padding)


def bottleneck_kernels(x: torch.Tensor, p: Bottleneck,
                       stride: int) -> torch.Tensor:
    """The kernel form of :func:`bottleneck` (counterpart of JAX's
    ``bottleneck_pallas``, clipbert_tpu/models/resnet.py:181-213), NHWC in
    and out: conv1 and the shortcut are fused 1x1 GEMMs with the BN epilogue
    (ops/matmul_bn_act.py), conv3 fuses the residual add and ReLU too; the
    3x3 conv2 stays cuDNN + bias + ReLU, as JAX keeps it on XLA."""
    out = conv1x1_bn_act(x, p.conv1.weight, p.conv1.bn.scale,
                         p.conv1.bn.bias, stride=stride, relu=True)
    out = torch.relu(frozen_bn(conv2d(_nchw(out), p.conv2.weight,
                                      padding=1), p.conv2.bn))
    sc = x
    if p.shortcut is not None:
        sc = conv1x1_bn_act(x, p.shortcut.weight, p.shortcut.bn.scale,
                            p.shortcut.bn.bias, stride=stride, relu=False)
    return conv1x1_bn_act(_nhwc(out), p.conv3.weight, p.conv3.bn.scale,
                          p.conv3.bn.bias, residual=sc, relu=True)


def _stages(p: ResNet50):
    for si in range(4):
        for bi, bp in enumerate(getattr(p, f"res{si + 2}")):
            yield bp, (1 if si == 0 else 2) if bi == 0 else 1


REMAT_MODES = (False, True, "stage", "block", "early")


def _checkpointed(fn):
    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return run


def resnet50_forward(p: ResNet50, x: torch.Tensor,
                     use_kernels: Optional[bool] = None,
                     remat=False) -> torch.Tensor:
    """(B, H, W, 3) preprocessed pixels -> (B, H/32, W/32, 2048) res5
    features, NHWC (reference backbone + get_conv5_features,
    grid_feat.py:95-97, with RES5_DILATION=1).

    ``use_kernels`` (the counterpart of JAX's ``use_pallas``): True runs the
    stem through ops/fused_stem_pool.py and the 1x1 convs through
    ops/matmul_bn_act.py (:func:`bottleneck_kernels`); False runs the cuDNN
    form; None picks the kernel form on a CUDA device. Both take folded and
    unfolded BN. The two forms round bf16 at other points (one rounding per
    fused 1x1 against one per conv, bias add and residual add), so they
    differ by about one bf16 ulp per layer.

    ``remat`` trades backward-pass memory for recompute in the cuDNN form
    (clipbert_tpu/models/resnet.py:252-320; ``torch.utils.checkpoint`` in
    place of ``jax.checkpoint``): False stores every activation; True or
    "early" checkpoints the stem, res2 and res3, whose activations are the
    largest; "stage" the stem and every stage; "block" the stem and every
    bottleneck."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, not {remat!r}")
    if use_kernels is None:
        use_kernels = kernels_default(x.device)
    if use_kernels and remat:
        raise ValueError("remat is a training option; the kernel form has "
                         "no backward")
    if use_kernels:
        weight = p.stem.conv.weight
        if p.stem.bn.scale is not None:
            weight = weight * p.stem.bn.scale[:, None, None, None]
        h = fused_stem_pool(x, weight, p.stem.bn.bias)
        for bp, stride in _stages(p):
            h = bottleneck_kernels(h, bp, stride)
        return h

    def stem_fn(x):
        h = conv2d(_nchw(x), p.stem.conv.weight, stride=2, padding=3)
        return max_pool(torch.relu(frozen_bn(h, p.stem.bn)), 3, 2, 1)

    block_fn = _checkpointed(bottleneck) if remat == "block" else bottleneck

    def stage_fn(h, si):
        for bi, bp in enumerate(getattr(p, f"res{si + 2}")):
            h = block_fn(h, bp, (1 if si == 0 else 2) if bi == 0 else 1)
        return h

    h = (_checkpointed(stem_fn) if remat else stem_fn)(x)
    for si in range(4):
        stage_remat = (remat == "stage"
                       or (remat in (True, "early") and si < 2))
        h = (_checkpointed(stage_fn) if stage_remat else stage_fn)(h, si)
    return _nhwc(h)


def grid_encoder_forward(p: GridEncoder, feat: torch.Tensor) -> torch.Tensor:
    """conv3x3 (2048 -> hidden) + maxpool 2x2/2 + ReLU (grid_feat.py:43-48);
    NHWC in and out."""
    h = conv2d(_nchw(feat), p.conv.weight, 1, padding=1)
    return _nhwc(torch.relu(max_pool(h, 2, 2)))


def grid_feat_forward(p: GridFeatBackbone, frames: torch.Tensor,
                      use_kernels: Optional[bool] = None,
                      remat=False) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, H/64, W/64, hidden) grid features; the
    frame axis folds into the batch (grid_feat.py:90-102). ``use_kernels``
    and ``remat`` as in :func:`resnet50_forward`."""
    B, T, H, W, C = frames.shape
    x = frames.reshape(B * T, H, W, C)
    feat = resnet50_forward(p.resnet, x, use_kernels, remat)
    grid = grid_encoder_forward(p.grid_encoder, feat)
    _, Hg, Wg, D = grid.shape
    return grid.reshape(B, T, Hg, Wg, D)
