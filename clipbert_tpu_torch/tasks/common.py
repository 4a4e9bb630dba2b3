"""Shared task-runner plumbing (port of clipbert_tpu/tasks/common.py):
tokenizer/store setup, the pixel constants, the compute dtype, the train
loader with its device preprocess one batch ahead, the eval loader, the
host-to-device batch move with the device preprocess, the deferred
device-to-host fetch window, the inference-time config restore and the
deploy checkpoint load."""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from clipbert_tpu_torch.ckpt import checkpoint
from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.core.mesh import rank_device
from clipbert_tpu_torch.data import loader, transforms
from clipbert_tpu_torch.data.store import open_store
from clipbert_tpu_torch.data.tokenization import BertTokenizer
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils import profiling

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


def make_batch_preprocess(cfg: RunConfig):
    """Batch hook for loader.PrefetchLoader: the device resize / pad /
    normalize (or the plain normalize of uint8 pixels), run as soon as the
    transfer is issued, one batch ahead of the consuming step."""
    mean, std = pixel_mean_std(cfg)
    compute_dtype = compute_dtype_for(cfg)

    def fn(batch: Dict) -> Dict:
        if "visual_src_hw" in batch:
            batch = dict(batch)
            batch["visual_inputs"] = transforms.resize_pad_normalize(
                batch["visual_inputs"], batch.pop("visual_src_hw"),
                cfg.max_img_size, mean, std, compute_dtype)
        elif ("visual_inputs" in batch
              and batch["visual_inputs"].dtype == torch.uint8):
            batch = dict(batch)
            batch["visual_inputs"] = transforms.normalize_pixels(
                batch["visual_inputs"], mean, std, compute_dtype)
        return batch

    return fn


def build_train_loader(dataset, collate_fn, cfg: RunConfig):
    """(infinite iterator of device batches, steps per epoch): this
    process's shuffled share of the dataset, cfg.train_batch_size items a
    batch (the tail dropped), collated by cfg.n_workers threads, moved to
    the run's device and preprocessed there one batch ahead."""
    sampler = loader.ShardedBatchSampler(
        len(dataset), cfg.train_batch_size, shuffle=True, seed=cfg.seed,
        process_index=dist.process_index(),
        process_count=dist.process_count(), drop_last=True)
    dl = loader.DataLoader(dataset, sampler, collate_fn,
                           num_workers=cfg.n_workers)
    pf = loader.PrefetchLoader(dl, device_for(cfg),
                               preprocess_fn=make_batch_preprocess(cfg))
    return loader.InfiniteIterator(pf), len(sampler)


class _EvalLoader(loader.DataLoader):
    """The eval loader: each batch's items and collate are a
    ``loader.batch`` span on the worker thread that builds them."""

    def _load_batch(self, indices):
        with profiling.span("loader.batch"):
            return super()._load_batch(indices)


def build_eval_loader(dataset, collate_fn, cfg: RunConfig, batch_size=None):
    """This process's share of the dataset in order, ``batch_size`` (or
    cfg.val_batch_size) items a batch, the tail batch short, collated by
    cfg.n_workers threads."""
    sampler = loader.ShardedBatchSampler(
        len(dataset), batch_size or cfg.val_batch_size, shuffle=False,
        process_index=dist.process_index(),
        process_count=dist.process_count(), drop_last=False)
    return _EvalLoader(dataset, sampler, collate_fn,
                       num_workers=cfg.n_workers)


def device_batch(batch: Dict, device: torch.device | str, mean=None,
                 std=None, compute_dtype=None,
                 cfg: Optional[RunConfig] = None):
    """A collated host batch -> (device tensors, host values): every
    numeric numpy array moves to ``device``; with ``visual_src_hw`` the
    native-size frames are resized, padded and normalized there
    (transforms.resize_pad_normalize), else the uint8 pixels are
    normalized. Lists (question ids) stay on the host."""
    if cfg is not None:
        cfg_mean, cfg_std = pixel_mean_std(cfg)
        mean = mean or cfg_mean
        std = std or cfg_std
    mean = mean or transforms.IMAGENET_MEAN_255
    std = std or transforms.IMAGENET_STD_1
    compute_dtype = compute_dtype or torch.bfloat16
    dev, host = {}, {}
    # pageable copies: the host is blocked for their length
    with profiling.span("device_batch.copy"):
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                dev[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            else:
                host[k] = v
    if "visual_src_hw" in dev and cfg is None:
        raise ValueError("the device preprocess needs cfg.max_img_size")
    with profiling.span("device_batch.preprocess"):
        if "visual_src_hw" in dev:
            dev["visual_inputs"] = transforms.resize_pad_normalize(
                dev["visual_inputs"], dev.pop("visual_src_hw"),
                cfg.max_img_size, mean, std, compute_dtype)
        elif "visual_inputs" in dev:
            dev["visual_inputs"] = transforms.normalize_pixels(
                dev["visual_inputs"], mean, std, compute_dtype)
    return dev, host


class HostFetch:
    """A device tensor's copy to the host, started now and waited for
    when read: on CUDA a non-blocking copy into pinned memory and an event
    recorded after it on the current stream, so the host goes on
    dispatching the next batch meanwhile."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = t, None

    def numpy(self) -> np.ndarray:
        with profiling.span("host_fetch.wait"):
            if self._done is not None:
                self._done.synchronize()
        return self._host.numpy()


# How many deferred eval fetches may stay in flight. Deferring the D2H
# conversions keeps the host decoding and dispatching instead of blocking
# per batch; the window bounds the device logits kept alive (VQA's ~3k-label
# head on a large val set would otherwise hold GBs until the loop ends).
EVAL_FETCH_WINDOW = 4


def drain_pending(pending: List, convert: Callable[[Any], None],
                  limit: int = EVAL_FETCH_WINDOW) -> None:
    """Convert (fetch) the oldest deferred entries until at most ``limit``
    remain in flight; call with ``limit=0`` after the loop to flush."""
    while len(pending) > limit:
        convert(pending.pop(0))


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
