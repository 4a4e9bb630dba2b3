"""Seeded weights in the published e2e checkpoint's key names, made on the
device in a few large calls, and their load into the port through its own
import path (the reference ``model_step_N.pt`` importer behind
``train/trainer.py::setup_model``).

Both sides take these tensors: the reference reads them as they are, the
port converts them (BN folded into scale / bias pairs, the stem flipped
for BGR, dense kernels transposed) as it would a released checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import clipbert_ref as ref

# how each kind of tensor is drawn: (mean, std) of a normal; std None:
# He-normal on fan-out for convolutions, 1 / sqrt(fan-in) for dense
# kernels (the scale of trained BERT-base kernels, ~0.04 at 768 inputs,
# which keeps the head's logits apart from one input to the next), the
# configured initializer_range for embedding tables
_NORMAL = {"dense": (0.0, None), "embed": (0.0, None), "bias": (0.0, 0.02),
           "ln_w": (1.0, 0.05), "ln_b": (0.0, 0.05), "bn_w": (1.0, 0.1),
           "bn_b": (0.0, 0.1), "bn_mean": (0.0, 0.1), "conv": (0.0, None)}


def make_weights(cfg: Dict, head: str, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device`` from ``seed``: one normal draw
    and one uniform draw for every tensor together, then sliced."""
    specs = ref.param_specs(cfg, head)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    n_var = sum(sz for (_, _, k), sz in zip(specs, sizes) if k == "bn_var")
    uniform = torch.rand(n_var, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = u_at = 0
    init_std = cfg["initializer_range"]
    for (name, shape, kind), sz in zip(specs, sizes):
        if kind == "bn_var":
            out[name] = (0.5 + uniform[u_at:u_at + sz]).reshape(shape)
            u_at += sz
            at += sz
            continue
        x = normal[at:at + sz].reshape(shape)
        at += sz
        mean, std = _NORMAL[kind]
        if std is None:
            if kind == "conv":
                cout, _, kh, kw = shape
                std = math.sqrt(2.0 / (kh * kw * cout))
            elif kind == "dense":
                std = 1.0 / math.sqrt(shape[1])
            else:
                std = init_std
        out[name] = x * std + mean
    pad = cfg["pad_token_id"]
    out[ref.BERT + "embeddings.word_embeddings.weight"][pad].zero_()
    return out


def load_into_port(weights: Dict[str, torch.Tensor], model_cfg, head: str,
                   bgr: bool, device: torch.device):
    """The port's model with every leaf taken from ``weights`` through the
    importer of the reference e2e checkpoint, strictly (a missing or
    mis-shaped leaf raises), as a serving load does."""
    from clipbert_tpu_torch.ckpt import checkpoint
    from clipbert_tpu_torch.ckpt.from_jax import (load_jax_params,
                                                  model_state, to_jax_flat)
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.train import trainer
    model = clipbert.empty_clipbert(model_cfg, head, device=device)
    flat = to_jax_flat(model_state(model))
    host = {k: v.detach().cpu().numpy() for k, v in weights.items()}
    loaded = checkpoint.flatten_tree(trainer.import_torch_e2e(
        host, model_cfg, head, bgr_checkpoint=bgr))
    merged, report = checkpoint.load_with_mismatch(flat, loaded)
    if report["missing"] or report["mismatched"]:
        raise ValueError(f"the seeded weights do not cover the port's "
                         f"model: missing {report['missing'][:8]}, "
                         f"mismatched {report['mismatched'][:8]}")
    load_jax_params(model, checkpoint.flatten_tree(merged))
    return model
