"""The operations of the deepseek_v3 joint encoder (Kimi-VL-A3B's language
model as ClipBERT's joint transformer), counted from the configuration's
shapes alone as benchmark/model_flops.py counts BERT's: 2 x the
multiply-adds of every product, elementwise work not counted."""

from __future__ import annotations

from typing import Dict


def deepseek_token_flops(cfg: Dict) -> float:
    """One token through the deepseek_v3 joint encoder's products
    (models/deepseek_v3.py), attention's two products aside: each layer's
    latent-attention projections, then layer 0's dense SwiGLU or a MoE
    layer's fp32 router, its k routed experts and its shared experts."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank, E, I = cfg["kv_lora_rank"], cfg["n_routed_experts"], \
        cfg["moe_intermediate_size"]
    attn = (D * H * (nope + rd) + D * (rank + rd) + rank * H * (nope + dv)
            + H * dv * D)
    dense = 3 * D * cfg["intermediate_size"]
    moe = (D * E + cfg["num_experts_per_tok"] * 3 * D * I
           + 3 * D * I * cfg["n_shared_experts"])
    n_dense = cfg["first_k_dense_replace"]
    L = cfg["num_hidden_layers"]
    return 2.0 * (L * attn + n_dense * dense + (L - n_dense) * moe)


def deepseek_seq_flops(cfg: Dict, seq: int, n_out: int) -> float:
    """One joint sequence of ``seq`` tokens through the deepseek_v3 joint
    encoder, causal attention's two products over the S (S + 1) / 2 pairs
    it keeps, and the MLP head on the pooled token."""
    H = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = seq * (seq + 1) / 2
    core = 2.0 * cfg["num_hidden_layers"] * H * pairs * (qk
                                                         + cfg["v_head_dim"])
    D = cfg["hidden_size"]
    hid = D * cfg.get("cls_hidden_scale", 2)
    return seq * deepseek_token_flops(cfg) + core + 2.0 * (D * hid
                                                           + hid * n_out)
