"""ClipBERT end to end: grid-feature CNN + cross-modal BERT + retrieval head
(port of clipbert_tpu/models/clipbert.py, inference path, head
``retrieval``).

Reference `ClipBertBaseModel` (`src/modeling/modeling.py:156-238`): text
embeddings ‖ visual embeddings, visual tokens always visible, 12-layer joint
encoder, tanh CLS pooler; the retrieval head is the 2-layer MLP classifier
(`modeling.py:523-580`). The module tree mirrors the JAX parameter tree
(``cnn.resnet``, ``cnn.grid_encoder``, ``transformer.bert.*``,
``transformer.classifier``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.models import bert, resnet, visual_embed
from clipbert_tpu_torch.ops.linear import linear

HEAD_TYPES = ("retrieval",)


class BertBase(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embeddings = bert.TextEmbeddings(cfg)
        self.visual_embeddings = visual_embed.VisualEmbeddings(cfg)
        self.encoder = bert.Encoder(cfg)
        self.pooler = bert.Pooler(cfg)


class MLPHead(nn.Module):
    """Linear -> ReLU -> Linear (modeling.py:338-343)."""

    def __init__(self, cfg: ModelConfig, out_dim: int):
        super().__init__()
        hid = cfg.hidden_size * cfg.cls_hidden_scale
        self.fc1 = nn.Linear(cfg.hidden_size, hid)
        self.fc2 = nn.Linear(hid, out_dim)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, head_type: str):
        super().__init__()
        if head_type not in HEAD_TYPES:
            raise ValueError(f"head {head_type!r} is not ported; "
                             f"ported heads: {HEAD_TYPES}")
        self.bert = BertBase(cfg)
        self.classifier = MLPHead(cfg, cfg.num_labels)


class ClipBert(nn.Module):
    def __init__(self, cfg: ModelConfig, head_type: str = "retrieval"):
        super().__init__()
        self.cnn = resnet.GridFeatBackbone(cfg.hidden_size,
                                           cfg.backbone_channel_in_size)
        self.transformer = Transformer(cfg, head_type)


@torch.no_grad()
def _init_weights(model: ClipBert, cfg: ModelConfig,
                  g: torch.Generator) -> None:
    """The JAX package's init distributions, drawn from ``g`` only:
    normal(0, initializer_range) for dense kernels and embedding tables
    (the text pad row zeroed), zero biases, unit LayerNorm, He-normal
    (fan_out) convs, identity frozen BN."""
    std = cfg.initializer_range
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, std, generator=g)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, std, generator=g)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, resnet.ConvBN)):
            cout, _, kh, kw = m.weight.shape
            m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)),
                             generator=g)
        elif isinstance(m, resnet.FrozenBN):
            m.scale.fill_(1.0)
            m.bias.zero_()
    emb = model.transformer.bert.embeddings.word_embeddings.weight
    emb[cfg.pad_token_id].zero_()


def empty_clipbert(cfg: ModelConfig, head_type: str = "retrieval", *,
                   device: torch.device | str) -> ClipBert:
    """The model allocated on ``device`` with uninitialized tensors, to be
    filled by a checkpoint (ckpt/from_jax.py). Built on the meta device,
    so no global RNG is drawn and nothing is initialized twice."""
    with torch.device("meta"):
        model = ClipBert(cfg, head_type)
    return model.to_empty(device=device)


def init_clipbert(cfg: ModelConfig, head_type: str = "retrieval", *,
                  generator: torch.Generator,
                  device: torch.device | str) -> ClipBert:
    """Random-init model on ``device``; every weight comes from
    ``generator`` (which must live on ``device``)."""
    model = empty_clipbert(cfg, head_type, device=device)
    _init_weights(model, cfg, generator)
    return model


def base_forward(p: BertBase, cfg: ModelConfig,
                 text_input_ids: torch.Tensor,      # (B, Lt)
                 text_input_mask: torch.Tensor,     # (B, Lt)
                 visual_tokens_grid: torch.Tensor,  # (B, T, H, W, D)
                 compute_dtype=torch.bfloat16,
                 fused_attn: bool = False,
                 mesh: Optional[Mesh] = None):
    """ClipBertBaseModel.forward (modeling.py:201-238): returns
    (sequence_output (B, Lt+Lv, D), pooled (B, D)). ``fused_attn`` and
    ``mesh`` as in bert.encoder."""
    text_emb = bert.text_embeddings(p.embeddings, text_input_ids, cfg,
                                    compute_dtype)
    vis_emb = visual_embed.visual_embeddings(
        p.visual_embeddings, visual_tokens_grid.to(compute_dtype), cfg)
    B, Lv = vis_emb.shape[:2]
    full_mask = torch.cat(
        [text_input_mask.float(),
         torch.ones((B, Lv), dtype=torch.float32, device=vis_emb.device)],
        dim=1)
    hidden = torch.cat([text_emb, vis_emb], dim=1)
    bias = bert.extended_attention_mask(full_mask)
    hidden = bert.encoder(p.encoder, hidden, bias, cfg, fused_attn=fused_attn,
                          mesh=mesh)
    return hidden, bert.pooler(p.pooler, hidden)


def mlp_head(p: MLPHead, pooled: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear, fp32 logits (dropout is train-only)."""
    return linear(torch.relu(linear(pooled, p.fc1)), p.fc2).float()


def cnn_forward(p: resnet.GridFeatBackbone, visual_pixels: torch.Tensor,
                compute_dtype=torch.bfloat16,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
    """(B, T, H, W, 3) preprocessed pixels -> (B, T, Hg, Wg, D) grid feats.
    ``use_kernels``: the CNN's kernel form (resnet.resnet50_forward); None
    takes it on a CUDA device."""
    return resnet.grid_feat_forward(p, visual_pixels.to(compute_dtype),
                                    use_kernels)


def fold_cnn_bn_scales(model: ClipBert) -> ClipBert:
    """Inference prep: frozen-BN scales folded into the R50 conv weights, in
    place (resnet.fold_bn_scales)."""
    resnet.fold_bn_scales(model.cnn.resnet)
    return model


def clipbert_forward(model: ClipBert, cfg: ModelConfig,
                     batch: Dict[str, torch.Tensor], head_type: str, *,
                     compute_dtype=torch.bfloat16,
                     visual_features: Optional[torch.Tensor] = None,
                     fused_attn: bool = False,
                     mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The per-clip unit of work, inference only, one text per visual.
    batch: text_input_ids (B, Lt), text_input_mask (B, Lt), and
    visual_inputs (B, T, H, W, 3) unless ``visual_features`` (precomputed
    grid features, (B, T, Hg, Wg, D)) is given. ``fused_attn`` and ``mesh``
    as in bert.encoder: under a tensor-parallel mesh the model holds this
    rank's shards (parallel/sharding.py::shard_model)."""
    if head_type not in HEAD_TYPES:
        raise ValueError(f"head {head_type!r} is not ported")
    if visual_features is None:
        visual_features = cnn_forward(model.cnn, batch["visual_inputs"],
                                      compute_dtype)
    tp = model.transformer
    _, pooled = base_forward(tp.bert, cfg, batch["text_input_ids"],
                             batch["text_input_mask"], visual_features,
                             compute_dtype, fused_attn=fused_attn, mesh=mesh)
    return {"logits": mlp_head(tp.classifier, pooled),
            "pooled_output": pooled}
