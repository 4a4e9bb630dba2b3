"""Shared task-runner plumbing, the parts inference runs (port of
clipbert_tpu/tasks/common.py): tokenizer/store setup, the pixel constants,
the compute dtype, the inference-time config restore and the deploy
checkpoint load."""

from __future__ import annotations

import logging

import torch

from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.core.mesh import rank_device
from clipbert_tpu_torch.data import transforms
from clipbert_tpu_torch.data.store import open_store
from clipbert_tpu_torch.data.tokenization import BertTokenizer
from clipbert_tpu_torch.models import clipbert

LOGGER = logging.getLogger(__name__)


def setup_tokenizer(cfg: RunConfig) -> BertTokenizer:
    return BertTokenizer.from_dir(cfg.tokenizer_dir)


def pixel_mean_std(cfg: RunConfig):
    """The configured normalization constants (img_pixel_mean/std,
    reference config.py:93-96) with the detectron2 caffe-style defaults."""
    mean = (tuple(cfg.img_pixel_mean) if cfg.img_pixel_mean
            else transforms.IMAGENET_MEAN_255)
    std = (tuple(cfg.img_pixel_std) if cfg.img_pixel_std
           else transforms.IMAGENET_STD_1)
    return mean, std


def compute_dtype_for(cfg: RunConfig) -> torch.dtype:
    """bf16 compute with fp32 parameters (the JAX package's mixed-precision
    policy, core/dtypes.py), or fp32 throughout."""
    return torch.bfloat16 if cfg.bf16 else torch.float32


def setup_store(path: str):
    return open_store(path)


def load_model_config(cfg: RunConfig, **overrides) -> ModelConfig:
    return ModelConfig.from_json(cfg.model_config, **overrides)


def device_for(cfg: RunConfig) -> torch.device:
    """This process's device: ``--device cuda`` is the process's local card
    (``cuda:{LOCAL_RANK}``, core/mesh.py::rank_device), so each rank of a
    torchrun launch drives its own. A CUDA device that is not there is an
    error, never a silent fall back to the CPU."""
    device = rank_device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available "
                           "(pass --device cpu to run the plain versions)")
    return device


def restore_inference_config(cfg: RunConfig) -> RunConfig:
    """At inference, replay the stored training args except inference_* keys
    (run_video_retrieval.py:737-766)."""
    stored = checkpoint.load_training_args(cfg.output_dir)
    if stored is None:
        LOGGER.warning("no stored training args found; using live config")
        return cfg
    return cfg.restore_from_training_args(stored)


def load_inference_params(cfg: RunConfig, model_cfg: ModelConfig,
                          head_type: str):
    """Load the step-addressed deployment checkpoint the JAX package wrote
    (``output_dir/model_step_{N}.npz``, run_video_qa.py:629-631; the newest
    when ``inference_model_step`` < 0) into the port's model on the run's
    device, with the frozen-BN scales folded into the conv weights. Returns
    (model, step)."""
    saver = checkpoint.ModelSaver(cfg.output_dir)
    step = cfg.inference_model_step
    if step < 0:
        steps_avail = saver.available_steps()
        if not steps_avail:
            raise FileNotFoundError(f"no checkpoints in {cfg.output_dir}")
        step = steps_avail[-1]
    path = saver.path(step)
    LOGGER.info(f"loading inference params from {path}")
    model = clipbert.empty_clipbert(model_cfg, head_type,
                                    device=device_for(cfg))
    load_jax_params(model, checkpoint.load_flat(path))
    clipbert.fold_cnn_bn_scales(model)
    return model.eval().requires_grad_(False), step
