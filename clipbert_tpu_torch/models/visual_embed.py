"""Visual input embedding (port of clipbert_tpu/models/visual_embed.py).

Reference VisualInputEmbedding (`src/modeling/modeling.py:40-101`): grid
(B, n_frm, H, W, D) -> temporal mean over frames -> + learned row/col
position embeddings -> (B, H*W, D) tokens -> in training, optional pixel
random sampling down to K tokens (indices drawn once per forward, shared by
the batch, sorted) -> + token-type embedding -> LayerNorm -> dropout in
training. The sequence ``position_embeddings`` table is unused in the
forward; it is kept so checkpoints round-trip.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.ops.dropout import dropout
from clipbert_tpu_torch.ops.layernorm import layer_norm


class VisualEmbeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.hidden_size
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, D)
        self.row_position_embeddings = nn.Embedding(
            cfg.max_grid_row_position_embeddings, D)
        self.col_position_embeddings = nn.Embedding(
            cfg.max_grid_col_position_embeddings, D)
        self.token_type_embeddings = nn.Embedding(1, D)
        self.ln = nn.LayerNorm(D)


def visual_embeddings(p: VisualEmbeddings, grid: torch.Tensor,
                      cfg: ModelConfig,
                      generator: Optional[torch.Generator] = None,
                      pixel_sampling_generator: Optional[torch.Generator]
                      = None) -> torch.Tensor:
    """(B, n_frm, H, W, D) grid features -> (B, Lv, D) visual tokens in the
    grid's dtype. Pixel random sampling runs only with
    ``pixel_sampling_generator`` (training) and 0 < K < H*W; dropout only
    with ``generator``."""
    B, T, H, W, D = grid.shape
    g = grid.mean(dim=1)                                      # (B, H, W, D)
    g = g + p.row_position_embeddings.weight[:H][None, :, None, :].to(g.dtype)
    g = g + p.col_position_embeddings.weight[:W][None, None, :, :].to(g.dtype)
    tokens = g.reshape(B, H * W, D)
    k = cfg.pixel_random_sampling_size
    if pixel_sampling_generator is not None and 0 < k < H * W:
        idx = torch.randperm(H * W, generator=pixel_sampling_generator,
                             device=tokens.device)[:k].sort().values
        tokens = tokens[:, idx]
    tokens = tokens + p.token_type_embeddings.weight[0][None, None, :].to(
        tokens.dtype)
    tokens = layer_norm(tokens, p.ln.weight, p.ln.bias, cfg.layer_norm_eps)
    return dropout(tokens, cfg.hidden_dropout_prob, generator)
