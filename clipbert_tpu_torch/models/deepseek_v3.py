"""DeepSeek-V3's decoder stack as ClipBERT's joint encoder
(``ModelConfig.joint_encoder == "deepseek_v3"``): the language model of
Kimi-VL-A3B (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct),
whose layer equations are those of DeepSeek-V3's published modeling code
(``modeling_deepseek.py``: DeepseekV3RMSNorm, DeepseekV3Attention,
DeepseekV3MLP, MoEGate, DeepseekV3MoE, DeepseekV3DecoderLayer).

A pre-norm decoder: h += MLA(rms_norm(h)); h += FFN(rms_norm(h)), the
first ``first_k_dense_replace`` FFNs dense SwiGLU of ``intermediate_size``
and the rest routed experts (ops/moe.py), then a final RMSNorm.

Latent attention (MLA, ``q_lora_rank`` None): q = W_q h split into
``qk_nope_head_dim`` + ``qk_rope_head_dim`` dims a head; [c | k_pe] =
W_kva h, with c (``kv_lora_rank``) through its own RMSNorm and W_kvb into
each head's k_nope and v; k_pe is one RoPE head shared by all heads. q's
and k's RoPE dims are rotated (DeepSeek's interleaved-to-half order,
:func:`rope`), so each head's q and k are 192 wide and its v 128, scaled
by 192^-1/2, under the causal mask and the key padding. On a CUDA device
the core is ops/fused_attention.py's tc body at those widths.

Every product is bias-free and goes through ops/linear.py::dense (the wg
GEMM on the card), apart from the router's fp32 product (ops/moe.py).
RMSNorm and RoPE run in fp32 and round once to the compute dtype; HF
rounds the normalised input before the weight multiply, and rotates with
cos/sin already rounded to bf16 (two departures of one rounding each).

Module and parameter names are the HF checkpoint's (``model.embed_tokens``,
``model.layers.{i}.self_attn.q_proj``, ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``, ``mlp.gate`` with
``e_score_correction_bias``, ``mlp.shared_experts.*``, ``model.norm``),
except that the routed experts are stacked for the grouped GEMM:
:func:`hf_expert_weights` maps them to and from the per-expert
``mlp.experts.{e}.{gate,up,down}_proj.weight``. The LM head is not
allocated: retrieval reads no vocabulary logits.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.ops import moe
from clipbert_tpu_torch.ops.fused_attention import (
    fused_attention, fused_attention_reference)
from clipbert_tpu_torch.ops.layernorm import rms_norm
from clipbert_tpu_torch.ops.linear import dense
from clipbert_tpu_torch.utils import profiling


def check_config(cfg: ModelConfig) -> None:
    """What this module computes of the DeepSeek-V3 config space."""
    unsupported = {
        "q_lora_rank": cfg.q_lora_rank is not None,
        "n_group": cfg.n_group != 1 or cfg.topk_group != 1,
        "scoring_func": cfg.scoring_func != "sigmoid",
        "topk_method": cfg.topk_method != "noaux_tc",
        "hidden_act": cfg.hidden_act != "silu",
    }
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise ValueError(f"the deepseek_v3 joint encoder does not compute "
                         f"{bad} as configured")


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))


def _linear(d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False)


class Attention(nn.Module):
    """MLA's projections (HF DeepseekV3Attention with q_lora_rank None)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, D = cfg.num_attention_heads, cfg.hidden_size
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.q_proj = _linear(D, H * qk)
        self.kv_a_proj_with_mqa = _linear(
            D, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = _linear(
            cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = _linear(H * cfg.v_head_dim, D)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)) (HF DeepseekV3MLP)."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = _linear(d, width)
        self.up_proj = _linear(d, width)
        self.down_proj = _linear(width, d)


class Gate(nn.Module):
    """The router (HF MoEGate): ``weight`` (E, D) and the selection-only
    ``e_score_correction_bias`` (E,), kept in fp32 as published."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E = cfg.n_routed_experts
        self.weight = nn.Parameter(torch.empty(E, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.empty(E))


class Experts(nn.Module):
    """The routed experts stacked: ``gate_up_proj`` (E, 2 I, D), expert
    e's gate_proj rows then its up_proj rows; ``down_proj`` (E, D, I)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, I, D = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                   cfg.hidden_size)
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * I, D))
        self.down_proj = nn.Parameter(torch.empty(E, D, I))


def hf_expert_weights(experts: Experts, prefix: str = "mlp.experts."
                      ) -> Dict[str, torch.Tensor]:
    """The stacked experts as the published checkpoint names them:
    ``{prefix}{e}.gate_proj.weight`` (I, D) = gate_up_proj[e, :I],
    ``up_proj`` = gate_up_proj[e, I:], ``down_proj`` (D, I) =
    down_proj[e] (views). An import stacks the same names back in."""
    gu, down = experts.gate_up_proj, experts.down_proj
    I = gu.shape[1] // 2
    out = {}
    for e in range(gu.shape[0]):
        out[f"{prefix}{e}.gate_proj.weight"] = gu[e, :I]
        out[f"{prefix}{e}.up_proj.weight"] = gu[e, I:]
        out[f"{prefix}{e}.down_proj.weight"] = down[e]
    return out


def hf_param_views(lm: "LanguageModel") -> Dict[str, torch.Tensor]:
    """Every parameter of ``lm`` under its published checkpoint name
    (``model.layers.{i}.self_attn.q_proj.weight``, ...), the stacked
    experts as their per-expert views (:func:`hf_expert_weights`): an
    import copies each published tensor into its view by name."""
    out = {name: p for name, p in lm.named_parameters()
           if ".mlp.experts." not in name}
    for i, layer in enumerate(lm.model.layers):
        if isinstance(layer.mlp, MoE):
            out.update(hf_expert_weights(layer.mlp.experts,
                                         f"model.layers.{i}.mlp.experts."))
    return out


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.gate = Gate(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = MLP(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, index: int):
        super().__init__()
        self.self_attn = Attention(cfg)
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size)
                    if index < cfg.first_k_dense_replace else MoE(cfg))
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size)


class LanguageModel(nn.Module):
    """HF DeepseekV3ForCausalLM's ``model``; no ``lm_head``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_config(cfg)
        self.model = Model(cfg)


def cast_params(lm: LanguageModel, dtype: torch.dtype) -> LanguageModel:
    """Every parameter in ``dtype`` (the published checkpoint's bf16) but
    the routers' correction biases, which stay fp32, in place."""
    for name, p in lm.named_parameters():
        if not name.endswith("e_score_correction_bias"):
            p.data = p.data.to(dtype)
    return lm


def rope_cos_sin(seq: int, dim: int, theta: float,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (seq, dim) cos and sin of positions 0..seq-1 at frequencies
    theta^(-2i/dim), each frequency twice (HF DeepseekV3RotaryEmbedding)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    f = torch.outer(torch.arange(seq, dtype=torch.float32, device=device),
                    inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """(B, S, H, d) in DeepSeek's interleaved layout -> rotated, in fp32:
    the pairs (x0, x1), (x2, x3) ... are first moved to the halves
    [x0 x2 ... | x1 x3 ...] (HF apply_rotary_pos_emb's view/transpose),
    then x cos + rotate_half(x) sin, cos/sin (S, d)."""
    B, S, H, d = x.shape
    x = x.float().reshape(B, S, H, d // 2, 2).transpose(-1, -2).reshape(
        B, S, H, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_bias: torch.Tensor, scale: float,
                   fused: bool) -> torch.Tensor:
    """Causal softmax(q k^T * scale + key_bias) v: the fused kernel on a
    CUDA tensor where ``fused`` (ops/fused_attention.py), else its plain
    version (any head widths; it has a backward)."""
    if fused and q.is_cuda:
        return fused_attention(q, k, v, key_bias, scale, causal=True)
    return fused_attention_reference(q, k, v, key_bias, scale, causal=True)


def mla(h: torch.Tensor, p: Attention, cfg: ModelConfig,
        key_bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
        fused: bool) -> torch.Tensor:
    """(B, S, D) normalised input -> (B, S, D) attention output."""
    B, S, _ = h.shape
    H = cfg.num_attention_heads
    nope, rd, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with profiling.span("mla.attention"):
        q = dense(h, p.q_proj.weight).view(B, S, H, nope + rd)
        ckv = dense(h, p.kv_a_proj_with_mqa.weight)
        c, k_pe = ckv.split([cfg.kv_lora_rank, rd], dim=-1)
        c = rms_norm(c, p.kv_a_layernorm.weight, cfg.rms_norm_eps)
        kv = dense(c, p.kv_b_proj.weight).view(B, S, H, nope + dv)
        k_nope, v = kv.split([nope, dv], dim=-1)
        q_pe = rope(q[..., nope:], cos, sin).to(h.dtype)
        k_pe = rope(k_pe.view(B, S, 1, rd), cos, sin).to(h.dtype)
        query = torch.cat([q[..., :nope], q_pe], dim=-1)
        key = torch.cat([k_nope, k_pe.expand(B, S, H, rd)], dim=-1)
        ctx = attention_core(query, key, v, key_bias,
                             (nope + rd) ** -0.5, fused)
        return dense(ctx.reshape(B, S, H * dv), p.o_proj.weight)


def swiglu_mlp(x: torch.Tensor, p: MLP) -> torch.Tensor:
    g = dense(x, p.gate_proj.weight)
    u = dense(x, p.up_proj.weight)
    return dense(torch.nn.functional.silu(g) * u, p.down_proj.weight)


def moe_layer(x: torch.Tensor, p: MoE, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D): the routed experts plus the shared ones."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    idx, w = moe.route(flat, p.gate.weight, p.gate.e_score_correction_bias,
                       cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                       cfg.norm_topk_prob)
    shared = swiglu_mlp(flat, p.shared_experts)
    out = moe.moe_experts(flat, idx, w, p.experts.gate_up_proj,
                          p.experts.down_proj, shared)
    return out.reshape(shape)


def decoder(lm: LanguageModel, hidden: torch.Tensor,
            key_bias: torch.Tensor, cfg: ModelConfig,
            fused_attn: bool = False) -> torch.Tensor:
    """(B, S, D) joint input embeddings, (B, S) additive key bias ->
    (B, S, D) hidden states after the last layer (before the final
    norm), positions 0..S-1 under the causal mask."""
    m = lm.model
    S = hidden.shape[1]
    cos, sin = rope_cos_sin(S, cfg.qk_rope_head_dim, cfg.rope_theta,
                            hidden.device)
    eps = cfg.rms_norm_eps
    for layer in m.layers:
        a = mla(rms_norm(hidden, layer.input_layernorm.weight, eps),
                layer.self_attn, cfg, key_bias, cos, sin, fused_attn)
        hidden = hidden + a
        x = rms_norm(hidden, layer.post_attention_layernorm.weight, eps)
        if isinstance(layer.mlp, MoE):
            f = moe_layer(x, layer.mlp, cfg)
        else:
            f = swiglu_mlp(x, layer.mlp)
        hidden = hidden + f
    return hidden


def last_token_pooled(lm: LanguageModel, hidden: torch.Tensor,
                      last: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final RMSNorm of each sequence's token ``last`` (B,): the
    pooled vector (the LM has no CLS token and no pooler). The norm is per
    token, so only the pooled rows are normalised."""
    rows = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    return rms_norm(rows, lm.model.norm.weight, cfg.rms_norm_eps)


def embed_tokens(lm: LanguageModel, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return lm.model.embed_tokens.weight[ids].to(dtype)
