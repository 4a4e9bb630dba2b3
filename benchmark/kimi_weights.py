"""Seeded weights of Kimi-VL-A3B's language model under the published
checkpoint's names, each tensor drawn on the device from (seed, name)
alone, straight into bf16 (the correction biases fp32, as published): one
float32 draw of all 15.6 B values (62 GB) would not fit beside the model,
and the plain reference redraws any layer's tensors by name and widens
them to float32, one layer at a time.

How each is drawn (the configuration's ``assumed.weight_scales``):
products, embeddings and the routers normal(0, initializer_range), as
DeepSeek-V3 initialises them; RMSNorm weights normal(1, 0.05); the
routers' correction biases normal(0, 0.05).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

NORM_STD = 0.05
BIAS_STD = 0.05


def specs(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """[(name, shape)] of every tensor of the language model without its
    LM head, the routed experts one by one, in a fixed order."""
    D = cfg["hidden_size"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], D))]
    for i in range(cfg["num_hidden_layers"]):
        out += layer_specs(cfg, i)
    out.append(("model.norm.weight", (D,)))
    return out


def layer_specs(cfg: Dict, i: int) -> List[Tuple[str, Tuple[int, ...]]]:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rd, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    pre = f"model.layers.{i}."
    a = pre + "self_attn."
    out = [(pre + "input_layernorm.weight", (D,)),
           (pre + "post_attention_layernorm.weight", (D,)),
           (a + "q_proj.weight", (H * (nope + rd), D)),
           (a + "kv_a_proj_with_mqa.weight", (rank + rd, D)),
           (a + "kv_a_layernorm.weight", (rank,)),
           (a + "kv_b_proj.weight", (H * (nope + dv), rank)),
           (a + "o_proj.weight", (D, H * dv))]

    def mlp(p, width):
        return [(p + "gate_proj.weight", (width, D)),
                (p + "up_proj.weight", (width, D)),
                (p + "down_proj.weight", (D, width))]

    if i < cfg["first_k_dense_replace"]:
        return out + mlp(pre + "mlp.", cfg["intermediate_size"])
    E, I = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out += [(pre + "mlp.gate.weight", (E, D)),
            (pre + "mlp.gate.e_score_correction_bias", (E,))]
    for e in range(E):
        out += mlp(f"{pre}mlp.experts.{e}.", I)
    return out + mlp(pre + "mlp.shared_experts.", I * cfg["n_shared_experts"])


def _seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % (1 << 63)


def tensor(cfg: Dict, seed: int, name: str, shape,
           device: torch.device) -> torch.Tensor:
    """The tensor ``name`` of seed ``seed``: bf16, or fp32 for a
    correction bias."""
    g = torch.Generator(device=device).manual_seed(_seed(seed, name))
    x = torch.randn(tuple(shape), generator=g, device=device)
    if name.endswith("e_score_correction_bias"):
        return x * BIAS_STD
    if name.endswith("norm.weight"):
        x = x * NORM_STD + 1.0
    else:
        x = x * cfg["initializer_range"]
    return x.to(torch.bfloat16)


def layer(cfg: Dict, seed: int, i: int,
          device: torch.device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s tensors widened to float32, for the reference."""
    return {n: tensor(cfg, seed, n, s, device).float()
            for n, s in layer_specs(cfg, i)}


@torch.no_grad()
def load_into_port(lm, cfg: Dict, seed: int, device: torch.device) -> None:
    """Every tensor copied into the port's language model by its
    published name (models/deepseek_v3.py::hf_param_views), strictly: a
    name on one side only, or a shape that differs, raises."""
    from clipbert_tpu_torch.models import deepseek_v3
    views = deepseek_v3.hf_param_views(lm)
    want = dict(specs(cfg))
    if set(views) != set(want):
        raise ValueError(f"the port's names differ from the published: "
                         f"{sorted(set(views) ^ set(want))[:8]}")
    for name, shape in want.items():
        if tuple(views[name].shape) != shape:
            raise ValueError(f"{name}: the port holds "
                             f"{tuple(views[name].shape)}, not {shape}")
        views[name].copy_(tensor(cfg, seed, name, shape, device))
