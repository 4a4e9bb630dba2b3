"""The float32 reference against cases worked by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import clipbert_ref as ref


def test_resize_size_truncates_as_published():
    assert ref.resize_size(240, 320, 448) == (336, 448)
    assert ref.resize_size(480, 640, 768) == (576, 768)
    assert ref.resize_size(321, 100, 448) == (448, 139)   # 139.56 -> 139


def test_preprocess_pads_and_normalizes():
    frames = torch.full((1, 2, 4, 3), 200, dtype=torch.uint8)
    x = ref.preprocess(frames, 8, (100.0, 50.0, 0.0), (2.0, 1.0, 1.0))
    # (2, 4) -> (4, 8): a constant resizes to the constant
    assert x.shape == (1, 3, 8, 8)
    assert torch.allclose(x[0, :, :4], torch.tensor(
        [50.0, 150.0, 200.0])[:, None, None].expand(3, 4, 8))
    # the pad is zero pixels, normalized
    assert torch.allclose(x[0, :, 4:], torch.tensor(
        [-50.0, -50.0, 0.0])[:, None, None].expand(3, 4, 8))


def test_frozen_bn_from_its_statistics():
    W = {"c.norm.weight": torch.tensor([2.0]), "c.norm.bias":
         torch.tensor([1.0]), "c.norm.running_mean": torch.tensor([3.0]),
         "c.norm.running_var": torch.tensor([4.0 - ref.BN_EPS])}
    x = torch.tensor([5.0]).reshape(1, 1, 1, 1)
    # (5 - 3) / 2 * 2 + 1
    assert ref._frozen_bn(x, W, "c").item() == pytest.approx(3.0)


def test_lse_loss_by_hand():
    logits = torch.tensor([[[0.0, 1.0], [2.0, 0.0]]])     # (1 text, 2 clips)
    label = torch.tensor([1])
    want = (math.log(math.exp(0) + math.exp(1) + math.exp(2) + math.exp(0))
            - math.log(math.exp(1) + math.exp(0)))
    assert ref.lse_loss(logits, label).item() == pytest.approx(want)


def test_retrieval_score_is_the_positive_log_odds():
    pooled = torch.tensor([[0.25, 1.0]])
    p = torch.softmax(pooled, -1)[0, 1]
    assert ref.retrieval_score_logit(pooled).item() == pytest.approx(
        math.log(p / (1 - p)))


def test_linear_lr_warms_up_and_floors():
    assert ref.linear_lr(1, 5e-5, 1000, 0.1) == pytest.approx(5e-7)
    assert ref.linear_lr(100, 5e-5, 1000, 0.1) == pytest.approx(5e-5)
    assert ref.linear_lr(1000, 5e-5, 1000, 0.1) == pytest.approx(1e-8)
    assert ref.linear_lr(1, 5e-5, 10**6, 0.1) == pytest.approx(1e-8)


def test_adamw_one_step_by_hand():
    p = {"w.weight": torch.tensor([1.0, -2.0]), "w.bias": torch.tensor([0.5])}
    opt = ref.AdamW(p, (0.9, 0.98), 1e-6, 0.1, 0.1, max_norm=1.0)
    g = {"w.weight": torch.tensor([3.0, 0.0]), "w.bias": torch.tensor([4.0])}
    clipped = opt.step(g, 0.01, 0.01)
    coef = 1.0 / (5.0 + 1e-6)                            # global norm 5
    assert clipped["w.weight"][0].item() == pytest.approx(3 * coef)
    # step 1: m / (sqrt(v) + eps) = sign(g), corrected by sqrt(1-b2)/(1-b1)
    corr = math.sqrt(1 - 0.98) / (1 - 0.9)
    gw = 3 * coef
    mw, vw = 0.1 * gw, 0.02 * gw * gw
    w0 = 1.0 - 0.01 * corr * mw / (math.sqrt(vw) + 1e-6)
    assert p["w.weight"][0].item() == pytest.approx(w0 * (1 - 0.01 * 0.1))
    assert p["w.weight"][1].item() == pytest.approx(-2.0 * (1 - 0.01 * 0.1))
    gb = 4 * coef                                         # no decay on bias
    b = 0.5 - 0.01 * corr * 0.1 * gb / (math.sqrt(0.02 * gb * gb) + 1e-6)
    assert p["w.bias"][0].item() == pytest.approx(b)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.05, -3.3])
    q = ref.Precision("fp8")(x)
    # scale 1: e4m3 keeps 3 mantissa bits
    assert q.tolist() == pytest.approx([448.0, 1.0, 1.0, -3.25])
    assert torch.equal(ref.FP32(x), x)


def test_worst_leaf_gap_takes_the_median_floor():
    ref_n = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 0.5}
    gap, leaf = ref.worst_leaf_gap(prog, ref_n)
    # c's gap is measured against the median leaf (1.0), not its own
    assert (leaf, gap) == ("c", pytest.approx(0.5))
    # over a and b the median leaf is b (2.0): 0.1 / 2
    assert ref.worst_leaf_gap(prog, ref_n, ["a", "b"])[0] == \
        pytest.approx(0.05)


def test_joint_forward_matches_a_hand_built_layer():
    """One layer, one head, D = 2: the encoder by hand."""
    cfg = {"hidden_size": 2, "intermediate_size": 2, "num_hidden_layers": 1,
           "num_attention_heads": 1, "layer_norm_eps": 1e-12}
    g = torch.Generator().manual_seed(0)
    W = {}
    pre = f"{ref.BERT}encoder.layer.0."
    for n in ("attention.self.query", "attention.self.key",
              "attention.self.value", "attention.output.dense",
              "intermediate.dense", "output.dense"):
        W[pre + n + ".weight"] = torch.randn(2, 2, generator=g)
        W[pre + n + ".bias"] = torch.randn(2, generator=g)
    for n in ("attention.output.LayerNorm", "output.LayerNorm"):
        W[pre + n + ".weight"] = torch.ones(2)
        W[pre + n + ".bias"] = torch.zeros(2)
    h = torch.randn(1, 3, 2, generator=g)
    mask = torch.tensor([[1, 1, 0]])
    got = ref.encoder(W, cfg, h, mask)

    def lin(x, n):
        return x @ W[pre + n + ".weight"].T + W[pre + n + ".bias"]

    def ln(x):
        return (x - x.mean(-1, keepdim=True)) / torch.sqrt(
            x.var(-1, unbiased=False, keepdim=True) + 1e-12)

    q, k, v = (lin(h[0], f"attention.self.{n}")
               for n in ("query", "key", "value"))
    s = q @ k.T / math.sqrt(2) + torch.tensor([0.0, 0.0, -10000.0])
    a = ln(lin(torch.softmax(s, -1) @ v, "attention.output.dense") + h[0])
    f = lin(torch.nn.functional.gelu(lin(a, "intermediate.dense")),
            "output.dense")
    assert torch.allclose(got[0], ln(f + a), atol=1e-5)


def test_param_specs_name_every_published_leaf():
    import json
    from benchmark.harness import ROOT
    cfg = json.loads((ROOT / "benchmark/configs/msrvtt_ret.json").read_text())
    specs = ref.param_specs(cfg, "retrieval")
    names = [n for n, _, _ in specs]
    assert len(names) == len(set(names))
    n_params = sum(np.prod(s) for n, s, _ in specs if ref.trainable(n))
    # BERT-base (~110M with its 30522 x 768 table), ResNet-50 (~23.5M),
    # the grid encoder (2048 x 768 x 9) and the head
    assert 1.45e8 < n_params < 1.55e8
    assert "cnn.feature.backbone.res5.2.conv3.weight" in names
    assert "transformer.classifier.2.weight" in names
