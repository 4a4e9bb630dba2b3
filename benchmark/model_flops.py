"""The operations ClipBERT needs, counted from the configuration's shapes
alone, whatever implements them: 2 x the multiply-adds of every product
(convolutions, dense layers, attention's two products). Elementwise work
(BN, ReLU, softmax, LayerNorm) is not counted, as MFU counts it nowhere.
A later change that removes work from the port does not move these."""

from __future__ import annotations

from typing import Dict

R50_STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


def _out(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def stem_flops(h: int, w: int) -> float:
    """The 7x7 / 2 stem convolution of one frame."""
    return 2.0 * _out(h, 2) * _out(w, 2) * 64 * 3 * 49


def cnn_flops(h: int, w: int, hidden: int, channels_in: int = 2048) -> float:
    """ResNet-50 (caffe bottlenecks, stride in the 1x1) and the grid
    encoder's conv3x3 on one (h, w) frame."""
    total = stem_flops(h, w)
    ch, cw = _out(h, 2), _out(w, 2)
    ch, cw = _out(ch, 2), _out(cw, 2)                 # 3x3 / 2 max pool
    cin = 64
    for si, (n, mid, cout) in enumerate(R50_STAGES):
        for bi in range(n):
            s = (1 if si == 0 else 2) if bi == 0 else 1
            oh, ow = _out(ch, s), _out(cw, s)
            c_in = cin if bi == 0 else cout
            macs = oh * ow * (c_in * mid + 9 * mid * mid + mid * cout)
            if bi == 0:
                macs += oh * ow * c_in * cout          # the shortcut
            total += 2.0 * macs
            ch, cw = oh, ow
        cin = cout
    total += 2.0 * ch * cw * channels_in * hidden * 9
    return total


def grid_tokens(size: int) -> int:
    """Visual tokens of a padded size x size frame (stride 32, then the
    grid encoder's 2x2 pool)."""
    side = _out(_out(size, 2), 2)
    for s in (1, 2, 2, 2):
        side = _out(side, s)
    return (side // 2) ** 2


def bert_seq_flops(cfg: Dict, seq: int, n_out: int) -> float:
    """One joint sequence of ``seq`` tokens through the encoder, the pooler
    and the MLP head."""
    D, I, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    per_layer = seq * (4 * D * D + 2 * D * I) + 2 * seq * seq * D
    hid = D * cfg.get("cls_hidden_scale", 2)
    head = D * D + D * hid + hid * n_out
    return 2.0 * (L * per_layer + head)


def joint_len(cfg: Dict) -> int:
    return cfg["max_txt_len"] + grid_tokens(cfg["max_img_size"])


def train_flops(forward: float, stem: float) -> float:
    """Forward, and a backward of twice the forward's products, less the
    stem's input gradient, which nothing needs."""
    return 3.0 * forward - stem
