"""The deepseek_v3 joint encoder (clipbert_tpu_torch/models/deepseek_v3.py,
ops/moe.py) against the plain reference (tests/kimi_vl_lm_ref.py) on the
CPU, at a tiny size with Kimi-VL's layout: hidden 64, 4 heads, q/k head
dim 24 (16 + 8 RoPE), v head dim 16, kv rank 32, 16 routed experts of
width 32 (top 4), one shared expert, layer 0 dense, on seeded weights.

Tolerances: the port runs float32 here, as the reference does, so the two
differ only in the order of float32 sums: rtol = atol = 1e-5 on values of
order 1 (products of at most 64 terms lose ~64 * 2^-24 ~ 4e-6 relative),
and 1e-4 on the head's logits, which follow three decoder layers of such
sums. Expert choices are compared exactly.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import kimi_vl_lm_ref as ref
from test_torch_moe_plan import tile_walk
from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.models import clipbert, deepseek_v3 as ds
from clipbert_tpu_torch.ops import moe
from clipbert_tpu_torch.ops.layernorm import rms_norm

TINY = dict(joint_encoder="deepseek_v3", hidden_size=64,
            num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, n_routed_experts=16,
            num_experts_per_tok=4, n_shared_experts=1,
            moe_intermediate_size=32, intermediate_size=96,
            num_hidden_layers=3, first_k_dense_replace=1, vocab_size=300,
            hidden_act="silu", backbone_channel_in_size=64,
            max_grid_row_position_embeddings=8,
            max_grid_col_position_embeddings=8, rope_theta=800000.0,
            routed_scaling_factor=2.446, rms_norm_eps=1e-5,
            layer_norm_eps=1e-12, score_agg_func="lse", num_labels=2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw})


def _rcfg(cfg: ModelConfig) -> dict:
    return cfg.to_dict()


def _draw(g: np.random.Generator, name: str, shape) -> np.ndarray:
    """Seeded weights at scales that make every path count: norms near 1,
    correction biases of 0.1, products 1 / sqrt(fan-in)."""
    if name.endswith("layernorm.weight") or name.endswith("norm.weight") \
            or name.endswith("LayerNorm.weight"):
        return 1.0 + 0.1 * g.standard_normal(shape)
    if name.endswith("e_score_correction_bias") or name.endswith(".bias"):
        return 0.1 * g.standard_normal(shape)
    if "embeddings" in name or "embed_tokens" in name:
        return g.standard_normal(shape)
    return g.standard_normal(shape) / math.sqrt(shape[-1])


def _model(cfg: ModelConfig, seed: int = 0):
    """(the port's retrieval model, the reference's weights) from one
    seeded draw per published name."""
    model = clipbert.empty_clipbert(cfg, "retrieval", device="cpu")
    tp = model.transformer
    g = np.random.default_rng(seed)
    W = {}
    with torch.no_grad():
        for name, view in ds.hf_param_views(tp.language_model).items():
            t = torch.from_numpy(_draw(g, name, tuple(view.shape))).float()
            view.copy_(t)
            W[name] = t
        ve = tp.visual_embeddings
        for name, p in (("row_position_embeddings.weight",
                         ve.row_position_embeddings.weight),
                        ("col_position_embeddings.weight",
                         ve.col_position_embeddings.weight),
                        ("token_type_embeddings.weight",
                         ve.token_type_embeddings.weight),
                        ("LayerNorm.weight", ve.ln.weight),
                        ("LayerNorm.bias", ve.ln.bias)):
            t = torch.from_numpy(_draw(g, name, tuple(p.shape))).float()
            p.copy_(t)
            W["visual_embeddings." + name] = t
        for name, p in tp.classifier.named_parameters():
            t = torch.from_numpy(_draw(g, name, tuple(p.shape))).float()
            p.copy_(t)
            W["classifier." + name] = t
    return model.eval(), W


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    model, W = _model(cfg)
    return cfg, model, W


def _x(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).float()


def test_rms_norm(world):
    cfg, _, W = world
    x = _x(1, 5, 7, 64) * 3.0
    w = W["model.layers.0.input_layernorm.weight"]
    torch.testing.assert_close(rms_norm(x, w, 1e-5), ref.rms_norm(x, w, 1e-5),
                               **TOL)


def test_rope_matches_deepseeks_interleaved_rotation():
    B, S, H, d = 2, 11, 3, 8
    x = _x(2, B, S, H, d)
    cos, sin = ds.rope_cos_sin(S, d, 800000.0, "cpu")
    rcos, rsin = ref.rope_cos_sin(S, d, 800000.0)
    torch.testing.assert_close(cos, rcos, rtol=0, atol=0)
    got = ds.rope(x, cos, sin)
    want = ref.apply_rope(x.transpose(1, 2), rcos, rsin).transpose(1, 2)
    torch.testing.assert_close(got, want, **TOL)
    # position 0 is the de-interleaving alone: (x0, x1, x2, x3, ...) ->
    # (x0, x2, ..., x1, x3, ...)
    torch.testing.assert_close(got[:, 0], torch.cat(
        [x[:, 0, :, 0::2], x[:, 0, :, 1::2]], dim=-1), **TOL)


def _bias(mask):
    return (1.0 - mask.float()) * -10000.0


def test_mla_with_padding_and_causal_mask(world):
    cfg, model, W = world
    B, S = 3, 13
    h = _x(3, B, S, 64)
    mask = torch.ones(B, S)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    lp = model.transformer.language_model.model.layers[1]
    cos, sin = ds.rope_cos_sin(S, 8, cfg.rope_theta, "cpu")
    with torch.no_grad():
        got = ds.mla(h, lp.self_attn, cfg, _bias(mask), cos, sin, True)
        want = ref.mla(W, "model.layers.1.self_attn.", _rcfg(cfg), h,
                       _bias(mask))
        torch.testing.assert_close(got, want, **TOL)
        # causal: a change at position 8 leaves positions 0..7 alone
        h2 = h.clone()
        h2[:, 8] += 5.0
        got2 = ds.mla(h2, lp.self_attn, cfg, _bias(mask), cos, sin, True)
    torch.testing.assert_close(got2[:, :8], got[:, :8], rtol=0, atol=0)
    assert not torch.allclose(got2[0, 8:], got[0, 8:])
    # a padded key carries no weight to any earlier or later query
    h3 = h.clone()
    h3[2, 5:] += 5.0
    with torch.no_grad():
        got3 = ds.mla(h3, lp.self_attn, cfg, _bias(mask), cos, sin, True)
    torch.testing.assert_close(got3[2, :5], got[2, :5], **TOL)


def test_router_and_the_correction_bias_that_changes_the_choice(world):
    cfg, model, W = world
    pre = "model.layers.1.mlp."
    x = _x(4, 40, 64)
    gate = model.transformer.language_model.model.layers[1].mlp.gate
    scores, _ = ref.router_scores(W, pre, x)
    # a bias that lifts the 5th-ranked expert of every token past the rest
    plain = torch.topk(scores, 5, dim=-1).indices
    lifted = torch.zeros(16)
    lifted[plain[0, 4]] = 1.0
    with torch.no_grad():
        for bias in (W[pre + "gate.e_score_correction_bias"], lifted):
            Wb = {**W, pre + "gate.e_score_correction_bias": bias}
            idx, w = moe.route(x, gate.weight, bias, 4, 2.446, True)
            s, biased = ref.router_scores(Wb, pre, x)
            want_idx = ref.select(biased, 4)
            assert torch.equal(idx, want_idx)
            torch.testing.assert_close(
                w, ref.route_weights(s, want_idx, _rcfg(cfg)), **TOL)
    # the bias chose an expert the scores alone would not have: token 0's
    # 5th, and its weight comes from the unbiased score
    assert plain[0, 4].item() in idx[0].tolist()
    assert plain[0, 4].item() not in torch.topk(scores[0], 4).indices.tolist()
    torch.testing.assert_close(w.sum(dim=-1), torch.full((40,), 2.446),
                               **TOL)


@pytest.mark.parametrize("case", ["seeded", "an idle expert",
                                  "every token on one expert"])
def test_moe_layer(world, case):
    cfg, model, W = world
    pre = "model.layers.2.mlp."
    p = model.transformer.language_model.model.layers[2].mlp
    bias = W[pre + "gate.e_score_correction_bias"].clone()
    if case == "an idle expert":
        bias[3] = -10.0
    elif case == "every token on one expert":
        bias[7] = 10.0
    Wb = {**W, pre + "gate.e_score_correction_bias": bias}
    x = _x(5, 2, 30, 64)
    with torch.no_grad():
        p.gate.e_score_correction_bias.copy_(bias)
        try:
            got = ds.moe_layer(x, p, cfg)
            idx, w = moe.route(x.reshape(-1, 64), p.gate.weight, bias, 4,
                               cfg.routed_scaling_factor, True)
        finally:
            p.gate.e_score_correction_bias.copy_(
                W[pre + "gate.e_score_correction_bias"])
    want, want_idx = ref.moe(Wb, pre, _rcfg(cfg), x.reshape(-1, 64))
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(got.reshape(-1, 64), want, **TOL)
    counts = torch.bincount(idx.reshape(-1), minlength=16)
    if case == "an idle expert":
        assert counts[3] == 0
    elif case == "every token on one expert":
        assert counts[7] == 60


def test_grouped_rows_match_the_plain_loop(world, monkeypatch):
    """The grouped path's layout and tile walk (plan_rows, the kernel's
    launch replaced by its plain tile walk from test_torch_moe_plan.py)
    give the plain loop's rows exactly: each expert's run starts on a
    128-row tile, padding rows are zero in and never read."""
    cfg, model, W = world
    p = model.transformer.language_model.model.layers[2].mlp
    x = _x(6, 300, 64)
    idx, w = moe.route(x, p.gate.weight, p.gate.e_score_correction_bias, 4,
                       2.446, True)
    plan = moe.plan_rows(idx, 16)
    counts = torch.bincount(idx.reshape(-1), minlength=16)
    assert torch.equal(plan.counts, counts)
    padded = (counts + 127) // 128 * 128
    assert plan.rows == moe.padded_rows(1200, 16) == 3328   # 3232 up
    assert int(plan.live_m) == int(padded.sum()) // 128
    starts = torch.cumsum(padded, 0) - padded
    for e in range(16):
        rows = plan.dest[idx == e]
        assert torch.equal(rows.sort().values,
                           starts[e] + torch.arange(int(counts[e])))
        for m in range(int(starts[e]) // 128,
                       int(starts[e] + padded[e]) // 128):
            assert int(plan.tile_expert[m]) == e
    # every buffer row copies its token, or the zero row past the end
    tok = torch.arange(300).repeat_interleave(4).reshape(300, 4)
    assert torch.equal(plan.src[plan.dest], tok)
    assert int((plan.src == 300).sum()) == plan.rows - 1200
    monkeypatch.setattr(moe, "_grouped_launch", tile_walk)
    with torch.no_grad():
        gate_up, down = p.experts.gate_up_proj, p.experts.down_proj
        y_g, dest_g = moe._experts_grouped(x, idx, gate_up, down)
        y_p, dest_p = moe._experts_plain(x, idx, gate_up, down)
    torch.testing.assert_close(y_g[dest_g], y_p[dest_p], rtol=0, atol=0)


def test_retrieval_forward_logits(world):
    cfg, model, W = world
    B, Lt = 4, 9
    grid = _x(7, B, 2, 3, 3, 64)
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        5, 300, (B, Lt)))
    mask = torch.ones(B, Lt, dtype=torch.long)
    mask[1, 6:] = 0
    mask[3, 3:] = 0
    with torch.no_grad():
        out = clipbert.clipbert_forward(
            model, cfg, {"text_input_ids": ids, "text_input_mask": mask},
            "retrieval", compute_dtype=torch.float32, visual_features=grid,
            fused_attn=True)
    want, chosen = ref.retrieval_logits(W, _rcfg(cfg), grid, ids, mask)
    assert len(chosen) == 2
    torch.testing.assert_close(out["logits"], want, rtol=1e-4, atol=1e-4)
    # the padded text tokens after the last valid one change nothing
    ids2 = ids.clone()
    ids2[3, 3:] = 7
    with torch.no_grad():
        out2 = clipbert.clipbert_forward(
            model, cfg, {"text_input_ids": ids2, "text_input_mask": mask},
            "retrieval", compute_dtype=torch.float32, visual_features=grid,
            fused_attn=True)
    torch.testing.assert_close(out2["logits"][3], out["logits"][3],
                               rtol=0, atol=0)


def test_train_and_int8_paths_refuse_the_encoder(world):
    cfg, model, _ = world
    batch = {"text_input_ids": torch.zeros(2, 4, dtype=torch.long),
             "text_input_mask": torch.ones(2, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="deepseek_v3"):
        clipbert.clipbert_forward(model, cfg, batch, "retrieval",
                                  visual_features=_x(9, 2, 1, 2, 2, 64),
                                  train=True)
    with pytest.raises(ValueError, match="deepseek_v3"):
        clipbert.quantize_scoring_params(model)


def test_parameter_names_are_the_published_ones(world):
    cfg, model, _ = world
    names = set(ds.hf_param_views(model.transformer.language_model))
    for want in ("model.embed_tokens.weight", "model.norm.weight",
                 "model.layers.0.mlp.gate_proj.weight",
                 "model.layers.1.self_attn.q_proj.weight",
                 "model.layers.1.self_attn.kv_a_proj_with_mqa.weight",
                 "model.layers.1.self_attn.kv_a_layernorm.weight",
                 "model.layers.1.self_attn.kv_b_proj.weight",
                 "model.layers.1.self_attn.o_proj.weight",
                 "model.layers.1.mlp.gate.weight",
                 "model.layers.1.mlp.gate.e_score_correction_bias",
                 "model.layers.2.mlp.experts.15.down_proj.weight",
                 "model.layers.2.mlp.shared_experts.up_proj.weight",
                 "model.layers.2.input_layernorm.weight",
                 "model.layers.2.post_attention_layernorm.weight"):
        assert want in names, want
    assert not any("lm_head" in n for n in names)
    # an expert's published tensors are views of the stacked weights
    views = ds.hf_param_views(model.transformer.language_model)
    gu = model.transformer.language_model.model.layers[2].mlp.experts
    assert views["model.layers.2.mlp.experts.5.up_proj.weight"] \
        .data_ptr() == gu.gate_up_proj[5, 32:].data_ptr()


def test_config_file_parameter_count_on_the_meta_device():
    """Kimi-VL-A3B's language model at its published widths, without the
    LM head: 15.62 B parameters (benchmark/configs/kimi_vl_a3b_ret.json)."""
    import json
    path = Path(__file__).resolve().parents[1] / "benchmark" / "configs" \
        / "kimi_vl_a3b_ret.json"
    raw = json.loads(path.read_text())
    fields = {f for f in ModelConfig.__dataclass_fields__}
    cfg = ModelConfig(**{k: v for k, v in raw.items() if k in fields})
    with torch.device("meta"):
        lm = ds.LanguageModel(cfg)
    n = sum(p.numel() for p in lm.parameters())
    D, E, I = 2048, 64, 1408
    attn = D * 16 * 192 + D * 576 + 512 + 512 * 16 * 256 + 16 * 128 * D
    moe_layer = E * 3 * D * I + 3 * D * 2 * I + E * D + E
    want = (163840 * D + 27 * (attn + 2 * D) + 3 * D * 11264
            + 26 * moe_layer + D)
    assert n == want
    assert round(n / 1e9, 2) == 15.62


def test_expert_load_is_tallied_only_while_collecting(world):
    from clipbert_tpu_torch.utils import profiling
    cfg, model, _ = world
    p = model.transformer.language_model.model.layers[2].mlp
    x = _x(10, 1, 25, 64)
    moe.reset_expert_load()
    with torch.no_grad():
        ds.moe_layer(x, p, cfg)
        assert moe.expert_load() is None
        with profiling.collect():
            ds.moe_layer(x, p, cfg)
            ds.moe_layer(x, p, cfg)
    idx, _ = moe.route(x.reshape(-1, 64), p.gate.weight,
                       p.gate.e_score_correction_bias, 4, 2.446, True)
    want = 2 * torch.bincount(idx.reshape(-1), minlength=16)
    assert torch.equal(moe.expert_load(), want)
    assert int(moe.expert_load().sum()) == 2 * 25 * 4
    moe.reset_expert_load()
