"""BERT encoder stack and pretraining heads (port of
clipbert_tpu/models/bert.py).

Post-LN transformer (reference vendored HF-2.11 BERT,
`src/modeling/transformers.py`): softmax(QK^T/sqrt(d)+mask)V attention,
exact-GELU FFN, tanh CLS pooler. Matmuls run in the compute dtype with fp32
accumulation (ops/linear.py); LayerNorm statistics and softmax run in fp32.

The JAX package stacks the 12 layers along a leading axis for ``lax.scan``;
here they are an ``nn.ModuleList`` run by a Python loop. Module and
parameter names follow the JAX parameter tree (``attention.self.query``,
``output.ln``, ...) so ckpt/from_jax.py maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.core.rng import derive_seed, generator
from clipbert_tpu_torch.ops.activations import ACT2FN
from clipbert_tpu_torch.ops.attention import SelfAttention, multi_head_attention
from clipbert_tpu_torch.ops.dropout import dropout
from clipbert_tpu_torch.ops.layernorm import layer_norm
from clipbert_tpu_torch.ops.linear import dense_row_parallel, linear, mm_f32


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, D)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, D)
        self.ln = nn.LayerNorm(D)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.ln = nn.LayerNorm(d_out)


class _Attention(nn.Module):
    def __init__(self, D: int):
        super().__init__()
        self.self = SelfAttention(D)
        self.output = _DenseLN(D, D)


class _Intermediate(nn.Module):
    def __init__(self, D: int, I: int):
        super().__init__()
        self.dense = nn.Linear(D, I)


class BertLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.attention = _Attention(D)
        self.intermediate = _Intermediate(D, I)
        self.output = _DenseLN(I, D)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class Pooler(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class _LMPrediction(nn.Module):
    """MLM transform + the decoder's bias (reference BertLMPredictionHead,
    transformers.py:497-515). The decoder weight is the word-embedding
    table, which :func:`mlm_logits` is given: the head holds no copy."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.hidden_size
        self.transform = _DenseLN(D, D)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size))


class PretrainingHeads(nn.Module):
    """MLM transform + tied-decoder bias + ITM/NSP linear (port of
    init_pretraining_heads; reference BertPreTrainingHeads,
    transformers.py:538-547)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.predictions = _LMPrediction(cfg)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)


def text_embeddings(p: TextEmbeddings, input_ids: torch.Tensor,
                    cfg: ModelConfig, compute_dtype,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """word + absolute-position + token-type(0) embeddings, then LN in the
    compute dtype and dropout with ``generator`` (training) (reference
    BertEmbeddings, transformers.py:151-199)."""
    L = input_ids.shape[1]
    emb = p.word_embeddings.weight[input_ids]
    emb = emb + p.position_embeddings.weight[:L][None, :, :]
    emb = emb + p.token_type_embeddings.weight[0][None, None, :]
    emb = layer_norm(emb.to(compute_dtype), p.ln.weight, p.ln.bias,
                     cfg.layer_norm_eps)
    return dropout(emb, cfg.hidden_dropout_prob, generator)


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} mask -> additive fp32 bias (B, 1, 1, L), HF's
    (1-mask)*-10000 convention."""
    return ((1.0 - mask.float()) * -10000.0)[:, None, None, :]


def encoder(p: Encoder, hidden: torch.Tensor, mask_bias: torch.Tensor,
            cfg: ModelConfig, fused_attn: bool = False,
            mesh: Optional[Mesh] = None,
            dropout_seed: Optional[int] = None,
            remat=False) -> torch.Tensor:
    """The post-LN layer stack (reference BertEncoder,
    transformers.py:429-461).

    With a tensor-parallel ``mesh`` (model axis > 1) the layers hold this
    rank's Megatron shards (parallel/sharding.py::shard_model): attention
    runs on the local heads and the FFN intermediate on its local columns;
    ``attention.output.dense`` and ``output.dense`` are row-parallel, one
    all-reduce each over the model group (ops/linear.py::
    dense_row_parallel). LayerNorms and residuals are computed whole on
    every rank. ``fused_attn`` as in ops/attention.py::multi_head_attention.

    Training: ``dropout_seed`` (the JAX ``dropout_key``) seeds three
    dropouts a layer (attention probabilities, attention output, FFN
    output), each from its own generator built inside the layer from
    (seed, layer, site); a truthy ``remat`` checkpoints every layer
    (``jax.checkpoint`` of the layer body), recomputing it, with the same
    masks, in the backward pass.
    """
    act = ACT2FN[cfg.hidden_act]
    eps = cfg.layer_norm_eps
    tp = mesh is not None and mesh.n_model > 1
    device = hidden.device

    def out_dense(x, layer):
        if tp:
            return dense_row_parallel(x, layer.weight, layer.bias,
                                      mesh.model_group)
        return linear(x, layer)

    def layer_fn(hidden, lp, i):
        g_attn, g_res, g_ffn = (
            generator(None if dropout_seed is None
                      else derive_seed(dropout_seed, i, j), device)
            for j in range(3))
        ctx = multi_head_attention(hidden, lp.attention.self,
                                   cfg.num_attention_heads, mask_bias,
                                   fused=fused_attn, mesh=mesh,
                                   dropout_rate=cfg.attention_probs_dropout_prob,
                                   generator=g_attn)
        ao = lp.attention.output
        a = dropout(out_dense(ctx, ao.dense), cfg.hidden_dropout_prob, g_res)
        hidden = layer_norm(a + hidden, ao.ln.weight, ao.ln.bias, eps)
        inter = act(linear(hidden, lp.intermediate.dense))
        out = dropout(out_dense(inter, lp.output.dense),
                      cfg.hidden_dropout_prob, g_ffn)
        return layer_norm(out + hidden, lp.output.ln.weight,
                          lp.output.ln.bias, eps)

    for i, lp in enumerate(p.layers):
        if remat:
            hidden = torch.utils.checkpoint.checkpoint(
                layer_fn, hidden, lp, i, use_reentrant=False)
        else:
            hidden = layer_fn(hidden, lp, i)
    return hidden


def pooler(p: Pooler, hidden: torch.Tensor) -> torch.Tensor:
    """tanh(W * h[CLS]) (reference BertPooler, transformers.py:464-476)."""
    return torch.tanh(linear(hidden[:, 0], p.dense))


def mlm_logits(heads: PretrainingHeads, word_embeddings: torch.Tensor,
               hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MLM prediction scores with the decoder weight tied to the input
    embedding matrix (reference BertLMPredictionHead,
    transformers.py:497-515): GELU(dense) and LayerNorm in the compute
    dtype, then the vocab-wide product with an fp32 result plus the fp32
    bias, as the JAX package computes it (``preferred_element_type``)."""
    t = heads.predictions.transform
    h = ACT2FN[cfg.hidden_act](linear(hidden, t.dense))
    h = layer_norm(h, t.ln.weight, t.ln.bias, cfg.layer_norm_eps)
    logits = mm_f32(h.reshape(-1, h.shape[-1]),
                    word_embeddings.to(h.dtype).t())
    logits = logits + heads.predictions.bias.float()
    return logits.reshape(h.shape[:-1] + (word_embeddings.shape[0],))


def itm_logits(heads: PretrainingHeads, pooled: torch.Tensor) -> torch.Tensor:
    """The 2-way image-text-match scores, fp32."""
    return linear(pooled, heads.seq_relationship).float()
