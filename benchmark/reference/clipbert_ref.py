"""Plain ClipBERT in float32 PyTorch: the yardstick the benchmark holds the
port's outputs against.

It follows the published model (jayleicn/ClipBERT, ``src/modeling/
grid_feat.py``, ``modeling.py``, ``transformers.py``) and reads the
weights under the published e2e checkpoint's key names
(``cnn.feature.backbone.res2.0.conv1.weight``, ``transformer.bert.encoder.
layer.0.attention.self.query.weight``, ``transformer.classifier.0.weight``
...), so it works out everything the port derives from them again itself:
the frozen BatchNorm from its four statistics, the RGB-to-BGR flip before
the stem, the resize, pad and normalization of the raw frames. It imports
nothing of the port and nothing of JAX.

Parts: ResNet-50 (detectron2 caffe bottlenecks, stride in the 1x1, frozen
BN, res5 dilation 1) and the grid encoder (conv3x3 + 2x2 max pool + ReLU);
the visual embedding (frame mean, row / column positions, token type,
LayerNorm); BERT-base (post-LN, exact GELU, additive -10000 mask); the
MLP head; clip pooling by LSE; the retrieval and VQA losses; AdamW with
the published grouping and global-norm clipping.

``Precision`` rounds the operands of every product (linear, conv,
attention) to a lower format before the float32 product: identity for the
reference itself, float8 e4m3 with a per-tensor scale for the control that
stands for a precision below the configured bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# (blocks, bottleneck channels, out channels) of res2..res5
R50_STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))
CNN = "cnn.feature.backbone."
BERT = "transformer.bert."
FP8_MAX = 448.0


def strict_fp32() -> None:
    """Products in true float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """Rounds product operands: ``"fp32"`` leaves them, ``"fp8"`` rounds
    each tensor to float8 e4m3 under a scale that maps its largest
    magnitude to 448. The gradient passes the rounding unchanged."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
            q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()


FP32 = Precision("fp32")


# ---------------------------------------------------------------------------
# weights: names, shapes and how the benchmark draws them
# ---------------------------------------------------------------------------

def param_specs(cfg: Dict, head: str) -> List[Tuple[str, Tuple[int, ...],
                                                    str]]:
    """[(name, shape, kind)] of every tensor of the e2e checkpoint, in a
    fixed order. ``kind`` says how the benchmark draws it: ``dense``
    normal(0, 1 / sqrt(fan-in)), ``embed`` normal(0, initializer_range),
    ``conv`` He-normal on fan-out,
    ``bias`` small normal, ``ln_w`` / ``ln_b`` near 1 / near 0,
    ``bn_w`` / ``bn_var`` near 1, ``bn_b`` / ``bn_mean`` small."""
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def conv(name, cout, cin, k, bn=True):
        out.append((name + ".weight", (cout, cin, k, k), "conv"))
        if bn:
            for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                               ("running_mean", "bn_mean"),
                               ("running_var", "bn_var")):
                out.append((f"{name}.norm.{leaf}", (cout,), kind))

    def dense(name, dout, din):
        out.append((name + ".weight", (dout, din), "dense"))
        out.append((name + ".bias", (dout,), "bias"))

    def ln(name, d):
        out.append((name + ".weight", (d,), "ln_w"))
        out.append((name + ".bias", (d,), "ln_b"))

    conv(CNN + "stem.conv1", 64, 3, 7)
    cin = 64
    for si, (n, mid, cout) in enumerate(R50_STAGES):
        for bi in range(n):
            pre = f"{CNN}res{si + 2}.{bi}"
            if bi == 0:
                conv(pre + ".shortcut", cout, cin, 1)
            conv(pre + ".conv1", mid, cin if bi == 0 else cout, 1)
            conv(pre + ".conv2", mid, mid, 3)
            conv(pre + ".conv3", cout, mid, 1)
        cin = cout
    out.append(("cnn.grid_encoder.0.weight",
                (D, cfg["backbone_channel_in_size"], 3, 3), "conv"))
    for name, rows in (("word_embeddings", cfg["vocab_size"]),
                       ("position_embeddings",
                        cfg["max_position_embeddings"]),
                       ("token_type_embeddings", cfg["type_vocab_size"])):
        out.append((f"{BERT}embeddings.{name}.weight", (rows, D), "embed"))
    ln(BERT + "embeddings.LayerNorm", D)
    for name, rows in (("position_embeddings",
                        cfg["max_position_embeddings"]),
                       ("row_position_embeddings",
                        cfg["max_grid_row_position_embeddings"]),
                       ("col_position_embeddings",
                        cfg["max_grid_col_position_embeddings"]),
                       ("token_type_embeddings", 1)):
        out.append((f"{BERT}visual_embeddings.{name}.weight", (rows, D),
                    "embed"))
    ln(BERT + "visual_embeddings.LayerNorm", D)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{BERT}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            dense(pre + "attention.self." + n, D, D)
        dense(pre + "attention.output.dense", D, D)
        ln(pre + "attention.output.LayerNorm", D)
        dense(pre + "intermediate.dense", I, D)
        dense(pre + "output.dense", D, I)
        ln(pre + "output.LayerNorm", D)
    dense(BERT + "pooler.dense", D, D)
    hid = D * cfg.get("cls_hidden_scale", 2)
    n_out = num_outputs(cfg, head)
    dense("transformer.classifier.0", hid, D)
    dense("transformer.classifier.2", n_out, hid)
    return out


def num_outputs(cfg: Dict, head: str) -> int:
    if head == "retrieval":
        return 2 if cfg.get("loss_type", "ce") == "ce" else 1
    return int(cfg["num_labels"])


def trainable(name: str) -> bool:
    """Frozen BN statistics and affines never train (the published
    FrozenBatchNorm2d)."""
    return ".norm." not in name


def no_decay(name: str) -> bool:
    """The published optimizer's no-decay set: biases and LayerNorm."""
    return name.endswith(".bias") or ".LayerNorm." in name


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def resize_size(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """Longer side to ``max_size``, int truncation (data_utils.py)."""
    if h >= w:
        return max_size, int(max_size * (w * 1.0 / h))
    return int(max_size * (h * 1.0 / w)), max_size


def preprocess(frames: torch.Tensor, max_size: int, mean, std
               ) -> torch.Tensor:
    """uint8 (N, H, W, 3) RGB -> float32 (N, 3, S, S): bilinear resize of
    the longer side to S (align_corners False), zero pad at the bottom and
    right, then (x - mean) / std."""
    N, H, W, _ = frames.shape
    nh, nw = resize_size(H, W, max_size)
    x = frames.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                      align_corners=False)
    x = F.pad(x, (0, max_size - nw, 0, max_size - nh))
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    if max(mean) <= 1.0:
        x = x / 255.0
    return (x - m[None, :, None, None]) / s[None, :, None, None]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _conv(x, w, stride=1, padding=0, prec: Precision = FP32):
    return F.conv2d(prec(x), prec(w), None, stride, padding)


def _frozen_bn(x, W: Dict, name: str):
    g, b = W[name + ".norm.weight"], W[name + ".norm.bias"]
    m, v = W[name + ".norm.running_mean"], W[name + ".norm.running_var"]
    scale = g * torch.rsqrt(v + BN_EPS)
    shift = b - m * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv_bn(x, W, name, stride=1, padding=0, prec=FP32):
    return _frozen_bn(_conv(x, W[name + ".weight"], stride, padding, prec),
                      W, name)


def cnn_forward(W: Dict, pixels: torch.Tensor, bgr: bool = True,
                prec: Precision = FP32) -> torch.Tensor:
    """(N, 3, H, W) normalized RGB -> (N, H/64, W/64, D) grid features."""
    x = pixels[:, [2, 1, 0]] if bgr else pixels
    x = torch.relu(_conv_bn(x, W, CNN + "stem.conv1", 2, 3, prec))
    x = F.max_pool2d(x, 3, 2, 1)
    for si, (n, _, _) in enumerate(R50_STAGES):
        for bi in range(n):
            pre = f"{CNN}res{si + 2}.{bi}"
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            sc = x
            if bi == 0:
                sc = _conv_bn(x, W, pre + ".shortcut", stride, 0, prec)
            h = torch.relu(_conv_bn(x, W, pre + ".conv1", stride, 0, prec))
            h = torch.relu(_conv_bn(h, W, pre + ".conv2", 1, 1, prec))
            h = _conv_bn(h, W, pre + ".conv3", 1, 0, prec)
            x = torch.relu(h + sc)
    g = _conv(x, W["cnn.grid_encoder.0.weight"], 1, 1, prec)
    g = torch.relu(F.max_pool2d(g, 2, 2))
    return g.permute(0, 2, 3, 1)


def _ln(x, W, name, eps):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], eps)


def _dense(x, W, name, prec=FP32):
    return F.linear(prec(x), prec(W[name + ".weight"]), W[name + ".bias"])


def visual_tokens(W: Dict, cfg: Dict, grid: torch.Tensor) -> torch.Tensor:
    """(B, T, h, w, D) grid -> (B, h*w, D) visual embeddings."""
    B, T, h, w, D = grid.shape
    pre = BERT + "visual_embeddings."
    g = grid.mean(dim=1)
    g = g + W[pre + "row_position_embeddings.weight"][:h][None, :, None]
    g = g + W[pre + "col_position_embeddings.weight"][:w][None, None]
    t = g.reshape(B, h * w, D) + W[pre + "token_type_embeddings.weight"][0]
    return _ln(t, W, pre + "LayerNorm", cfg["layer_norm_eps"])


def text_tokens(W: Dict, cfg: Dict, ids: torch.Tensor) -> torch.Tensor:
    pre = BERT + "embeddings."
    L = ids.shape[1]
    e = W[pre + "word_embeddings.weight"][ids]
    e = e + W[pre + "position_embeddings.weight"][:L][None]
    e = e + W[pre + "token_type_embeddings.weight"][0]
    return _ln(e, W, pre + "LayerNorm", cfg["layer_norm_eps"])


def encoder(W: Dict, cfg: Dict, h: torch.Tensor, mask: torch.Tensor,
            prec: Precision = FP32) -> torch.Tensor:
    B, L, D = h.shape
    nh = cfg["num_attention_heads"]
    dh = D // nh
    eps = cfg["layer_norm_eps"]
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{BERT}encoder.layer.{i}."

        def heads(t):
            return t.reshape(B, L, nh, dh).transpose(1, 2)

        q = heads(_dense(h, W, pre + "attention.self.query", prec))
        k = heads(_dense(h, W, pre + "attention.self.key", prec))
        v = heads(_dense(h, W, pre + "attention.self.value", prec))
        s = prec(q) @ prec(k).transpose(-1, -2) / math.sqrt(dh) + bias
        p = torch.softmax(s, dim=-1)
        ctx = (prec(p) @ prec(v)).transpose(1, 2).reshape(B, L, D)
        a = _dense(ctx, W, pre + "attention.output.dense", prec)
        h = _ln(a + h, W, pre + "attention.output.LayerNorm", eps)
        f = F.gelu(_dense(h, W, pre + "intermediate.dense", prec))
        f = _dense(f, W, pre + "output.dense", prec)
        h = _ln(f + h, W, pre + "output.LayerNorm", eps)
    return h


def joint_logits(W: Dict, cfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
                 vis: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """Text ids / mask (B, Lt) and visual tokens (B, Lv, D) -> the head's
    logits (B, n_out): joint BERT, tanh pooler on [CLS], MLP head."""
    h = torch.cat([text_tokens(W, cfg, ids), vis], dim=1)
    full = torch.cat([mask.float(), torch.ones(vis.shape[:2],
                                               device=vis.device)], dim=1)
    h = encoder(W, cfg, h, full, prec)
    pooled = torch.tanh(_dense(h[:, 0], W, BERT + "pooler.dense", prec))
    x = torch.relu(_dense(pooled, W, "transformer.classifier.0", prec))
    return _dense(x, W, "transformer.classifier.2", prec)


def video_grids(W: Dict, cfg: Dict, frames: torch.Tensor, n_clips: int,
                prec: Precision = FP32, chunk: int = 8) -> torch.Tensor:
    """uint8 (n_clips * num_frm, H, W, 3) of one video -> (n_clips, T, h,
    w, D) grids, ``chunk`` frames at a time."""
    grids = []
    for s in range(0, frames.shape[0], chunk):
        px = preprocess(frames[s:s + chunk], cfg["max_img_size"],
                        cfg["img_pixel_mean"], cfg["img_pixel_std"])
        grids.append(cnn_forward(W, px, cfg["img_input_format"] == "BGR",
                                 prec))
    g = torch.cat(grids)
    return g.reshape((n_clips, -1) + g.shape[1:])


def retrieval_pooled(W: Dict, cfg: Dict, grids: torch.Tensor,
                     ids: torch.Tensor, mask: torch.Tensor,
                     prec: Precision = FP32) -> torch.Tensor:
    """One video's (n_clips, T, h, w, D) grids against captions (B, Lt):
    (B, n_out) clip logits pooled by LSE over the clips."""
    vis = visual_tokens(W, cfg, grids)              # (nc, Lv, D)
    nc = vis.shape[0]
    B = ids.shape[0]
    logits = joint_logits(
        W, cfg, ids.repeat(nc, 1), mask.repeat(nc, 1),
        vis.repeat_interleave(B, dim=0), prec)      # (nc * B, n_out)
    logits = logits.reshape(nc, B, -1)
    return torch.logsumexp(logits, dim=0)


def retrieval_score_logit(pooled: torch.Tensor) -> torch.Tensor:
    """The positive-class log-odds of a ce head's pooled logits: the
    softmax probability the eval reports, as logit(p) = l1 - l0."""
    return pooled[:, 1] - pooled[:, 0]


# ---------------------------------------------------------------------------
# training: the retrieval loss and AdamW
# ---------------------------------------------------------------------------

def lse_loss(clip_logits: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
    """Per text (B, nc, L) -> (B,): LSE over every (clip, label) logit
    less the LSE over clips of the label's (run_video_retrieval.py)."""
    B = clip_logits.shape[0]
    all_lse = torch.logsumexp(clip_logits.reshape(B, -1), dim=-1)
    per = torch.logsumexp(clip_logits, dim=1)
    return all_lse - per.gather(1, labels.reshape(-1, 1).long())[:, 0]


def retrieval_train_loss_sum(W: Dict, cfg: Dict, pixels: torch.Tensor,
                             ids: torch.Tensor, mask: torch.Tensor,
                             labels: torch.Tensor, n_clips: int,
                             group: int, prec: Precision = FP32
                             ) -> torch.Tensor:
    """Sum of the per-text losses of a block of videos. ``pixels``:
    normalized float (B_v, n_clips * num_frm, S, S, 3); the texts (B_v *
    group, Lt) follow their video in order."""
    Bv = pixels.shape[0]
    S = pixels.shape[2]
    x = pixels.reshape(-1, S, S, 3).permute(0, 3, 1, 2)
    g = cnn_forward(W, x, cfg["img_input_format"] == "BGR", prec)
    g = g.reshape((Bv, n_clips, -1) + g.shape[1:])       # (Bv, nc, T, ...)
    vis = visual_tokens(W, cfg, g.reshape((Bv * n_clips,) + g.shape[2:]))
    vis = vis.reshape((Bv, n_clips) + vis.shape[1:])
    vis = vis.repeat_interleave(group, dim=0)            # (Bt, nc, Lv, D)
    Bt = ids.shape[0]
    logits = joint_logits(
        W, cfg, ids.repeat_interleave(n_clips, dim=0),
        mask.repeat_interleave(n_clips, dim=0),
        vis.reshape((Bt * n_clips,) + vis.shape[2:]), prec)
    return lse_loss(logits.reshape(Bt, n_clips, -1), labels).sum()


def linear_lr(step: int, base: float, total: int, warmup_ratio: float
              ) -> float:
    """Linear warm-up then linear decay, floored at 1e-8
    (src/optimization/sched.py)."""
    warm = max(float(int(warmup_ratio * total)), 1.0)
    if step < warm:
        f = step / warm
    else:
        f = max(0.0, (total - step) / max(total - warm, 1.0))
    return max(base * f, 1e-8)


class AdamW:
    """HF AdamW with decoupled weight decay and bias correction
    (src/optimization/adamw.py), after clipping by the global norm
    (torch.nn.utils.clip_grad_norm_), over the trainable tensors. The CNN's
    tensors take the CNN's learning rate and weight decay; biases and
    LayerNorm take no decay."""

    def __init__(self, params: Dict[str, torch.Tensor], betas, eps: float,
                 weight_decay: float, cnn_weight_decay: float,
                 max_norm: float):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = (weight_decay, cnn_weight_decay)
        self.max_norm = max_norm
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float, cnn_lr: float
             ) -> Dict[str, torch.Tensor]:
        """One update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        coef = torch.clamp(self.max_norm / (norm + 1e-6), max=1.0)
        self.t += 1
        corr = math.sqrt(1 - self.b2 ** self.t) / (1 - self.b1 ** self.t)
        clipped = {}
        for n, p in self.params.items():
            cnn = n.startswith("cnn.")
            rate = cnn_lr if cnn else lr
            wd = 0.0 if no_decay(n) else self.wd[int(cnn)]
            g = grads[n] * coef
            clipped[n] = g
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt().add_(self.eps), value=-rate * corr)
            if wd > 0:
                p.add_(p, alpha=-rate * wd)
        return clipped


def chunks(n: int, size: int) -> Iterable[slice]:
    for s in range(0, n, size):
        yield slice(s, min(n, s + size))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """|prog - ref| / max(ref, the median leaf's ref), leaf by leaf: the
    gap of two norms, against the leaf's own or the median leaf's."""
    names = list(ref) if names is None else list(names)
    vals = sorted(ref[n] for n in names)
    med = vals[len(vals) // 2] if vals else 0.0
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names: Optional[Iterable[str]] = None) -> Tuple[float,
                                                                  str]:
    """The largest of :func:`leaf_gaps`; (gap, leaf)."""
    gaps = leaf_gaps(prog, ref, names)
    where = max(gaps, key=gaps.get) if gaps else ""
    return gaps.get(where, 0.0), where


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    names: Optional[Iterable[str]] = None) -> float:
    """The median of :func:`leaf_gaps`."""
    vals = sorted(leaf_gaps(prog, ref, names).values())
    return vals[len(vals) // 2] if vals else 0.0
