"""ClipBERT end to end: grid-feature CNN + cross-modal BERT + task heads
(port of clipbert_tpu/models/clipbert.py).

Reference `ClipBertBaseModel` (`src/modeling/modeling.py:156-238`): text
embeddings ‖ visual embeddings, visual tokens always visible, 12-layer joint
encoder, tanh CLS pooler. Heads: PreTraining (MLM on the text slice + 2-way
ITM, :241-307), SequenceClassification (2-layer MLP, :327-384),
MultipleChoice (:387-451), Regression (:454-507) and VideoTextRetrieval
(:523-580). The module tree mirrors the JAX parameter tree (``cnn.resnet``,
``cnn.grid_encoder``, ``transformer.bert.*``, ``transformer.classifier`` /
``regressor`` / ``cls``). The per-element losses mirror the reference's
reduction="none".
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.core.rng import RngGen
from clipbert_tpu_torch.models import bert, resnet, visual_embed
from clipbert_tpu_torch.ops.dropout import dropout
from clipbert_tpu_torch.ops.linear import linear

HEAD_TYPES = ("pretrain", "seq_cls", "multi_choice", "regression", "retrieval")


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


class RegressorBN(nn.Module):
    """BatchNorm1d in eval form: the affine ``scale``/``bias`` and the
    running ``mean``/``var`` under the JAX leaf names."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.register_buffer("mean", torch.empty(dim))
        self.register_buffer("var", torch.empty(dim))


class Regressor(nn.Module):
    """Linear -> ELU -> BN -> Linear to one output (modeling.py:454-507)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.hidden_size
        self.fc1 = nn.Linear(D, D)
        self.bn = RegressorBN(D)
        self.fc2 = nn.Linear(D, 1)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, head_type: str):
        super().__init__()
        if head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head type {head_type!r}; heads: "
                             f"{HEAD_TYPES}")
        self.bert = BertBase(cfg)
        if head_type == "pretrain":
            self.cls = bert.PretrainingHeads(cfg)
        elif head_type in ("seq_cls", "retrieval"):
            self.classifier = MLPHead(cfg, cfg.num_labels)
        elif head_type == "multi_choice":
            self.classifier = MLPHead(cfg, 1)
        else:
            self.regressor = Regressor(cfg)

    @property
    def mlm_decoder_weight(self) -> nn.Parameter:
        """The MLM decoder weight: the word-embedding table itself
        (reference BertLMPredictionHead's tied decoder), one Parameter."""
        return self.bert.embeddings.word_embeddings.weight


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
    (the text pad row zeroed; the tied MLM decoder is the same table), zero
    biases, unit LayerNorm, He-normal (fan_out) convs, identity frozen BN
    and regressor BN (unit variance, zero mean)."""
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
        elif isinstance(m, RegressorBN):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, bert._LMPrediction):
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
                 mesh: Optional[Mesh] = None,
                 rngs: Optional[RngGen] = None,
                 train: bool = False,
                 remat=False):
    """ClipBertBaseModel.forward (modeling.py:201-238): returns
    (sequence_output (B, Lt+Lv, D), pooled (B, D)). ``fused_attn`` and
    ``mesh`` as in bert.encoder. ``train`` draws the dropout (and pixel
    sampling) generators from ``rngs`` under the JAX names; ``remat``
    checkpoints the encoder layers."""
    rngs = rngs if train else None

    def gen(name):
        return None if rngs is None else rngs(name)

    text_emb = bert.text_embeddings(p.embeddings, text_input_ids, cfg,
                                    compute_dtype, generator=gen("emb_dropout"))
    vis_emb = visual_embed.visual_embeddings(
        p.visual_embeddings, visual_tokens_grid.to(compute_dtype), cfg,
        generator=gen("vis_dropout"),
        pixel_sampling_generator=(gen("pixel_sampling")
                                  if cfg.pixel_random_sampling_size > 0
                                  else None))
    B, Lv = vis_emb.shape[:2]
    full_mask = torch.cat(
        [text_input_mask.float(),
         torch.ones((B, Lv), dtype=torch.float32, device=vis_emb.device)],
        dim=1)
    hidden = torch.cat([text_emb, vis_emb], dim=1)
    bias = bert.extended_attention_mask(full_mask)
    hidden = bert.encoder(
        p.encoder, hidden, bias, cfg, fused_attn=fused_attn, mesh=mesh,
        dropout_seed=None if rngs is None else rngs.seed("enc_dropout"),
        remat=remat)
    return hidden, bert.pooler(p.pooler, hidden)


def mlp_head(p: MLPHead, pooled: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear, fp32 logits (dropout is train-only)."""
    return linear(torch.relu(linear(pooled, p.fc1)), p.fc2).float()


def cnn_forward(p: resnet.GridFeatBackbone, visual_pixels: torch.Tensor,
                compute_dtype=torch.bfloat16,
                use_kernels: Optional[bool] = None,
                remat=False) -> torch.Tensor:
    """(B, T, H, W, 3) preprocessed pixels -> (B, T, Hg, Wg, D) grid feats.
    ``use_kernels``: the CNN's kernel form (resnet.resnet50_forward); None
    takes it on a CUDA device, which has no backward: training passes
    False. ``remat`` as in resnet.resnet50_forward."""
    return resnet.grid_feat_forward(p, visual_pixels.to(compute_dtype),
                                    use_kernels, remat)


def fold_cnn_bn_scales(model: ClipBert) -> ClipBert:
    """Inference prep: frozen-BN scales folded into the R50 conv weights, in
    place (resnet.fold_bn_scales)."""
    resnet.fold_bn_scales(model.cnn.resnet)
    return model


def repeat_for_texts(visual_feats: torch.Tensor,
                     group_size: int) -> torch.Tensor:
    """Fan visual features out to the texts grouped with each visual
    (data_utils.py:344-357): (B_v, ...) -> (B_v * G, ...), rows repeated
    consecutively."""
    if group_size == 1:
        return visual_feats
    return visual_feats.repeat_interleave(group_size, dim=0)


def clipbert_forward(model: ClipBert, cfg: ModelConfig,
                     batch: Dict[str, torch.Tensor], head_type: str, *,
                     compute_dtype=torch.bfloat16,
                     visual_features: Optional[torch.Tensor] = None,
                     group_size: int = 1,
                     fused_attn: bool = False,
                     mesh: Optional[Mesh] = None,
                     train: bool = False,
                     rngs: Optional[RngGen] = None,
                     remat=False,
                     use_kernels: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
    """The per-clip unit of work. In eval (``train`` False) no dropout runs
    and regression's BN uses its stored running statistics. ``train``
    turns on dropout, drawn from ``rngs`` (core/rng.py), pixel random
    sampling and the regression BN's batch statistics; ``remat`` as in
    resnet.resnet50_forward and bert.encoder. ``use_kernels`` picks the
    CNN's form when the batch carries pixels.

    batch: text_input_ids (B, Lt), text_input_mask (B, Lt), and
    visual_inputs (B_v, T, H, W, 3) unless ``visual_features`` (precomputed
    grid features, (B_v, T, Hg, Wg, D)) is given, with B = B_v *
    ``group_size``: each visual is fanned out to the ``group_size`` texts
    that follow it. ``fused_attn`` and ``mesh`` as in bert.encoder: under a
    tensor-parallel mesh the model holds this rank's shards
    (parallel/sharding.py::shard_model).

    Returns ``logits`` (fp32) for seq_cls, retrieval and multi_choice (one
    logit per text) and regression (one value), or ``mlm_scores`` (B, Lt,
    vocab) and ``itm_scores`` (B, 2) for pretrain; and ``pooled_output``."""
    if head_type not in HEAD_TYPES:
        raise ValueError(f"unknown head type {head_type!r}")
    if visual_features is None:
        visual_features = cnn_forward(model.cnn, batch["visual_inputs"],
                                      compute_dtype, use_kernels, remat)
    visual_features = repeat_for_texts(visual_features, group_size)
    tp = model.transformer
    hidden, pooled = base_forward(tp.bert, cfg, batch["text_input_ids"],
                                  batch["text_input_mask"], visual_features,
                                  compute_dtype, fused_attn=fused_attn,
                                  mesh=mesh, rngs=rngs, train=train,
                                  remat=remat)

    def drop(x, name):
        return dropout(x, cfg.hidden_dropout_prob,
                       rngs(name) if train and rngs is not None else None)

    out: Dict[str, torch.Tensor] = {}
    if head_type == "pretrain":
        txt_len = batch["text_input_mask"].shape[1]
        # the text slice into the MLM head, as modeling.py:283-285
        out["mlm_scores"] = bert.mlm_logits(
            tp.cls, tp.mlm_decoder_weight, hidden[:, :txt_len], cfg)
        out["itm_scores"] = bert.itm_logits(tp.cls, pooled)
    elif head_type == "regression":
        rp = tp.regressor
        h = F.elu(linear(drop(pooled, "head_dropout"), rp.fc1).float())
        # BatchNorm1d: batch statistics in training, the stored running
        # statistics in eval
        if train:
            mean, var = h.mean(dim=0), h.var(dim=0, unbiased=False)
        else:
            mean, var = rp.bn.mean, rp.bn.var
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = h * rp.bn.scale + rp.bn.bias
        h = drop(h, "reg_dropout")
        out["logits"] = linear(h.to(compute_dtype), rp.fc2).float()
    else:
        pooled = drop(pooled, "head_dropout")
        out["logits"] = mlp_head(tp.classifier, pooled)
    out["pooled_output"] = pooled
    return out


# ---------------------------------------------------------------------------
# losses (per element, as the reference's reduction="none")
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """Per-element CE; with ``ignore_index`` the ignored positions give 0
    (torch CrossEntropyLoss(reduction='none'))."""
    logits = logits.float()
    labels = labels.long()
    if ignore_index is not None:
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0)
    else:
        valid, safe = None, labels
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
    return nll


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-element binary CE with logits (modeling.py:310-316)."""
    logits = logits.float()
    targets = targets.float()
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def mse(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.square(logits.float().reshape(-1)
                        - labels.float().reshape(-1))


def classification_loss(cfg: ModelConfig, logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """SequenceClassification.calc_loss (modeling.py:364-384),
    per element."""
    if cfg.num_labels == 1:
        return mse(logits, labels)
    if cfg.loss_type == "bce":
        return bce_with_logits(logits, labels)
    if cfg.loss_type == "ce":
        return cross_entropy(logits.reshape(-1, cfg.num_labels),
                             labels.reshape(-1))
    raise ValueError(f"invalid loss_type {cfg.loss_type}")


def retrieval_rank_loss(logits: torch.Tensor, sample_size: int,
                        margin: float) -> torch.Tensor:
    """Margin triplet loss over sigmoid scores viewed as (sample_size, -1),
    column 0 positive (modeling.py:567-575)."""
    scores = torch.sigmoid(logits.float().reshape(-1))
    scores = scores.reshape(sample_size, -1)
    return (margin + scores[:, 1:] - scores[:, :1]).clamp(min=0.0)


def pretrain_losses(cfg: ModelConfig, out: Dict[str, torch.Tensor],
                    mlm_labels: Optional[torch.Tensor],
                    itm_labels: Optional[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """MLM + ITM per-element losses (modeling.py:287-298). mlm_labels uses
    -100 for ignored positions, which give 0 loss and still count in the
    mean a step takes, as in the reference."""
    losses = {}
    if mlm_labels is not None:
        losses["mlm_loss"] = cross_entropy(
            out["mlm_scores"].reshape(-1, cfg.vocab_size),
            mlm_labels.reshape(-1), ignore_index=-100)
    if itm_labels is not None:
        losses["itm_loss"] = cross_entropy(out["itm_scores"].reshape(-1, 2),
                                           itm_labels.reshape(-1))
    return losses
