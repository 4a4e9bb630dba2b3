"""Plain float32 reference of Kimi-VL-A3B's language model as ClipBERT's
joint encoder, written from DeepSeek-V3's published modeling code
(``modeling_deepseek.py``) in plain torch: no kernel, cache, batching
trick or module of the program under test.

    h = [visual tokens | word embeddings]          positions 0..S-1
    for each layer:
        h = h + MLA(rms_norm(h))                   causal, key padding
        h = h + FFN(rms_norm(h))                   dense SwiGLU, then MoE
    pooled = rms_norm(h[last valid text token])
    logits = fc2(relu(fc1(pooled)))                 ClipBERT's MLP head

Weights are a dict of float32 tensors under the published checkpoint's
names (``model.layers.{i}.self_attn.q_proj.weight``, per-expert
``model.layers.{i}.mlp.experts.{e}.gate_proj.weight``, ...), plus
``visual_embeddings.*`` (ClipBERT's visual embedding) and ``classifier.
fc1`` / ``fc2`` (its head). ``cfg`` is a dict of the published config's
keys.

Departures from Kimi-VL, each deliberate:
- the vision tower (MoonViT and its projector) is ClipBERT's visual
  embedding of grid features; visual tokens come first, then the text;
- the key padding of the text is an additive (1 - mask) * -10000, as
  ClipBERT masks, on top of the causal mask;
- the pooled vector is the last valid text token after the final norm,
  read by ClipBERT's MLP head; no LM head;
- everything is float32 (the published model runs in bf16); RoPE's cos and
  sin and RMSNorm's normalised input are not rounded before their
  products.

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are set
False by :func:`strict_fp32`, so a product on a GPU is not run in TF32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """DeepseekV3RMSNorm."""
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_cos_sin(S: int, dim: int, theta: float, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepseekV3RotaryEmbedding: (S, dim) cos and sin, each frequency
    theta^(-2i/dim) twice."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float()
                           / dim))
    freqs = torch.outer(torch.arange(S, device=device).float(), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """apply_rotary_pos_emb on (B, H, S, d): DeepSeek's view/transpose moves
    each interleaved pair (x0, x1) to the halves, then rotate_half."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos[None, None] + rotate_half(x) * sin[None, None]


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.t()


def mla(Wt: W, pre: str, cfg: Dict, h: torch.Tensor,
        key_bias: torch.Tensor) -> torch.Tensor:
    """DeepseekV3Attention (q_lora_rank None) on the normalised (B, S, D)
    input: key_bias (B, S) additive, the causal mask on top."""
    B, S, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, rd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = linear(h, Wt[pre + "q_proj.weight"]).view(B, S, H, nope + rd)
    q = q.transpose(1, 2)
    q_nope, q_pe = q.split([nope, rd], dim=-1)
    ckv = linear(h, Wt[pre + "kv_a_proj_with_mqa.weight"])
    c, k_pe = ckv.split([rank, rd], dim=-1)
    k_pe = k_pe.view(B, S, 1, rd).transpose(1, 2)
    c = rms_norm(c, Wt[pre + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = linear(c, Wt[pre + "kv_b_proj.weight"]).view(B, S, H, nope + dv)
    kv = kv.transpose(1, 2)
    k_nope, v = kv.split([nope, dv], dim=-1)
    cos, sin = rope_cos_sin(S, rd, cfg["rope_theta"], h.device)
    q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(B, H, S, rd)], dim=-1)
    s = query @ key.transpose(-1, -2) * (nope + rd) ** -0.5
    s = s + key_bias[:, None, None, :]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    s = s.masked_fill(causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    ctx = (p @ v).transpose(1, 2).reshape(B, S, H * dv)
    return linear(ctx, Wt[pre + "o_proj.weight"])


def swiglu(Wt: W, pre: str, x: torch.Tensor) -> torch.Tensor:
    """DeepseekV3MLP."""
    g = linear(x, Wt[pre + "gate_proj.weight"])
    u = linear(x, Wt[pre + "up_proj.weight"])
    return linear(F.silu(g) * u, Wt[pre + "down_proj.weight"])


def router_scores(Wt: W, pre: str, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoEGate's sigmoid scores (T, E) and the biased scores that pick."""
    scores = torch.sigmoid(linear(x, Wt[pre + "gate.weight"]))
    return scores, scores + Wt[pre + "gate.e_score_correction_bias"]


def select(biased: torch.Tensor, k: int) -> torch.Tensor:
    """noaux_tc with one group: the top k biased scores (T, k)."""
    return torch.topk(biased, k, dim=-1).indices


def route_weights(scores: torch.Tensor, idx: torch.Tensor,
                  cfg: Dict) -> torch.Tensor:
    w = scores.gather(1, idx)
    if idx.shape[1] > 1 and cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * cfg["routed_scaling_factor"]


def moe(Wt: W, pre: str, cfg: Dict, x: torch.Tensor,
        idx: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepseekV3MoE on (T, D): returns (output, the chosen experts).
    ``idx`` (T, k) given: those experts, weighted from this router's
    scores (a caller's selection, so near-ties are not counted twice)."""
    scores, biased = router_scores(Wt, pre, x)
    if idx is None:
        idx = select(biased, cfg["num_experts_per_tok"])
    w = route_weights(scores, idx, cfg)
    out = swiglu(Wt, pre + "shared_experts.", x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(Wt, f"{pre}experts.{e}.", x[tok])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out, idx


def layer(Wt: W, i: int, cfg: Dict, h: torch.Tensor, key_bias: torch.Tensor,
          idx: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """DeepseekV3DecoderLayer i on (B, S, D): (output, its experts (B S,
    k), or None for a dense layer)."""
    pre = f"model.layers.{i}."
    eps = cfg["rms_norm_eps"]
    h = h + mla(Wt, pre + "self_attn.", cfg,
                rms_norm(h, Wt[pre + "input_layernorm.weight"], eps),
                key_bias)
    x = rms_norm(h, Wt[pre + "post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return h + swiglu(Wt, pre + "mlp.", x), None
    B, S, D = x.shape
    f, idx = moe(Wt, pre + "mlp.", cfg, x.reshape(B * S, D), idx)
    return h + f.view(B, S, D), idx


def visual_tokens(Wt: W, cfg: Dict, grid: torch.Tensor) -> torch.Tensor:
    """ClipBERT's visual embedding: (B, T, h, w, D) grid -> (B, h w, D)."""
    B, T, h, w, D = grid.shape
    pre = "visual_embeddings."
    g = grid.mean(dim=1)
    g = g + Wt[pre + "row_position_embeddings.weight"][:h][None, :, None]
    g = g + Wt[pre + "col_position_embeddings.weight"][:w][None, None]
    t = g.reshape(B, h * w, D) + Wt[pre + "token_type_embeddings.weight"][0]
    return F.layer_norm(t, (D,), Wt[pre + "LayerNorm.weight"],
                        Wt[pre + "LayerNorm.bias"], cfg["layer_norm_eps"])


def joint_input(Wt: W, cfg: Dict, grid: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(visual tokens | word embeddings (B, S, D), key bias (B, S), the
    last valid text token (B,))."""
    vis = visual_tokens(Wt, cfg, grid)
    txt = Wt["model.embed_tokens.weight"][ids]
    B, Lv = vis.shape[:2]
    full = torch.cat([torch.ones(B, Lv, device=vis.device), mask.float()],
                     dim=1)
    last = Lv + mask.long().sum(dim=1) - 1
    return torch.cat([vis, txt], dim=1), (1.0 - full) * -10000.0, last


def pooled(Wt: W, cfg: Dict, h: torch.Tensor,
           last: torch.Tensor) -> torch.Tensor:
    rows = h[torch.arange(h.shape[0], device=h.device), last]
    return rms_norm(rows, Wt["model.norm.weight"], cfg["rms_norm_eps"])


def head(Wt: W, p: torch.Tensor) -> torch.Tensor:
    """ClipBERT's MLP head: fc2(relu(fc1(p)))."""
    x = torch.relu(linear(p, Wt["classifier.fc1.weight"])
                   + Wt["classifier.fc1.bias"])
    return linear(x, Wt["classifier.fc2.weight"]) + Wt["classifier.fc2.bias"]


def retrieval_logits(Wt: W, cfg: Dict, grid: torch.Tensor, ids: torch.Tensor,
                     mask: torch.Tensor,
                     selections: Optional[List[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(B, n_out) head logits of (B, T, h, w, D) grids against (B, Lt)
    texts, and each MoE layer's experts; ``selections`` gives the MoE
    layers their experts in order."""
    h, key_bias, last = joint_input(Wt, cfg, grid, ids, mask)
    chosen = []
    for i in range(cfg["num_hidden_layers"]):
        given = None
        if i >= cfg["first_k_dense_replace"] and selections is not None:
            given = selections[i - cfg["first_k_dense_replace"]]
        h, idx = layer(Wt, i, cfg, h, key_bias, given)
        if idx is not None:
            chosen.append(idx)
    return head(Wt, pooled(Wt, cfg, h, last)), chosen
