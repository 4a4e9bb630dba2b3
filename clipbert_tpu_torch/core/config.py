# Copied from clipbert_tpu/core/config.py (ModelConfig only): JAX-free host code.
"""Model configuration (the ``base_model.json`` contract).

:class:`ModelConfig` holds the BERT-base fields, the ClipBERT extras (2D grid
position-embedding table sizes, the CNN output channel count) and the
task-injected attributes (num_labels / loss_type / classifier / ...).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class ModelConfig:
    """Architecture config (reference `src/configs/base_model.json`)."""

    # BERT encoder
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    # ClipBERT visual extras (reference base_model.json + modeling.py:40-60)
    max_grid_row_position_embeddings: int = 100
    max_grid_col_position_embeddings: int = 100
    max_temporal_position_embeddings: int = 100
    backbone_channel_in_size: int = 2048

    # Task-injected attributes (reference injects these into BertConfig at
    # runner setup, e.g. run_video_qa.py:166-176)
    num_labels: int = 2
    loss_type: str = "ce"  # ce | bce | mse | rank
    classifier: str = "mlp"  # mlp | linear
    cls_hidden_scale: int = 2
    margin: float = 0.2  # ranking loss margin (retrieval)
    pixel_random_sampling_size: int = 0  # 0 disables; pretrain uses 100
    score_agg_func: str = "mean"  # mean | max | lse (cross-clip aggregation)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, path: str, **overrides: Any) -> "ModelConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
