"""Train and inference steps (port of clipbert_tpu/train/steps.py): the
clip-folded ``mil_forward`` in its eval form and its train form, the
losses, the train step with gradient accumulation and the schedules, the
eval steps, the pretraining eval step, the cached-feature encode and
scoring steps, and the video-QA and QA answer steps.

Training runs the plain forms, as the JAX train step does: the cuDNN CNN
and the einsum attention core (no kernel of the port has a backward; the
wrappers refuse a launch under autograd). Per-step semantics follow the
reference (run_video_retrieval.py:396-421, run_video_qa.py:455-560): the
clip-axis fold, clip aggregation by mean, max or LSE, the 8-group AdamW
with the schedules evaluated at the post-increment step, clipping by global
norm, and micro-batches accumulated in fp32 and averaged.

The JAX steps are jitted programs memoized per configuration; here a step
is a plain closure run eagerly under ``torch.inference_mode``. A process
drives one device. The scoring steps take a (data, model) ``Mesh`` of
ranks (core/mesh.py): each rank scores its data shard of the captions with
the encoder Megatron-split over the model axis, and the shards are
gathered over the data axis, where the JAX steps let GSPMD and shard_map
split one program over the devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.core.mesh import Mesh
from clipbert_tpu_torch.core.rng import RngGen, derive_seed
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.ops import kernels_default
from clipbert_tpu_torch.parallel.sharding import tp_split_dim
from clipbert_tpu_torch.train import optim, sched
from clipbert_tpu_torch.train.optim import AdamWState, OptimConfig


@dataclass(frozen=True)
class TaskSettings:
    """Static per-task step configuration."""

    head_type: str                  # pretrain|seq_cls|multi_choice|regression|retrieval
    num_labels: int = 2
    loss_type: str = "ce"           # ce|bce|mse|rank
    score_agg_func: str = "mean"    # mean|max|lse
    train_n_clips: int = 1          # clips folded per mil_forward call
    group_size: int = 1             # texts per visual
    use_mlm: bool = True
    use_itm: bool = True
    margin: float = 0.2             # rank loss margin
    scale_loss_by_num_labels: bool = False  # VQA bce convention
    remat: Any = False   # False|True|'stage'|'block'|'early' (training)


@dataclass(frozen=True)
class ScheduleSettings:
    """LR schedule configuration for the two parameter families."""

    learning_rate: float = 5e-5
    cnn_learning_rate: float = 5e-5
    decay: str = "linear"
    cnn_decay: str = "linear"
    num_train_steps: int = 1000
    warmup_ratio: float = 0.1
    step_decay_epochs: Optional[Tuple[int, ...]] = None
    cnn_step_decay_epochs: Optional[Tuple[int, ...]] = None
    steps_per_epoch: int = 0  # needed only for multi_step decay

    def lrs(self, global_step):
        """(transformer lr, cnn lr) at ``global_step``, fp32."""
        epoch = (sched.f32(global_step) / sched.f32(self.steps_per_epoch)
                 if self.steps_per_epoch else sched.f32(0.0))
        lr_t = sched.get_lr(global_step, self.decay, self.learning_rate,
                            self.num_train_steps, self.warmup_ratio,
                            self.step_decay_epochs, epoch)
        lr_c = sched.get_lr(global_step, self.cnn_decay,
                            self.cnn_learning_rate, self.num_train_steps,
                            self.warmup_ratio, self.cnn_step_decay_epochs,
                            epoch)
        return lr_t, lr_c


@dataclass
class TrainState:
    """The model (its parameters are the trained weights, updated in
    place) and the optimizer state."""
    model: clipbert.ClipBert
    opt: AdamWState


def init_train_state(model: clipbert.ClipBert,
                     meta: Dict[str, optim.GroupMeta]) -> TrainState:
    """Marks the trainable parameters (the rest stop tracking gradients)
    and allocates the optimizer state."""
    for n, p in model.named_parameters():
        p.requires_grad_(meta[n].trainable)
    return TrainState(model, optim.init_adamw_state(model, meta))


def _mil_forward(model, cfg, ts, batch, compute_dtype, use_kernels,
                 fused_attn, train=False, rngs=None, remat=False,
                 mesh=None):
    vis = batch["visual_inputs"]
    B_v = vis.shape[0]
    nc = ts.train_n_clips
    nf = vis.shape[1] // nc
    H, W, C = vis.shape[2:]
    G = ts.group_size
    vis = vis.reshape(B_v, nc, nf, H, W, C).transpose(0, 1)
    vis = vis.reshape(nc * B_v, nf, H, W, C)
    feats = clipbert.cnn_forward(model.cnn, vis, compute_dtype, use_kernels,
                                 remat)
    if G > 1:
        # fan out to texts: consecutive repeat inside each clip block
        feats = feats.reshape((nc, B_v) + feats.shape[1:])
        feats = feats.repeat_interleave(G, dim=1)
        feats = feats.reshape((nc * B_v * G,) + feats.shape[2:])
    B_t = batch["text_input_ids"].shape[0]
    if B_t != B_v * G:
        raise ValueError(f"{B_t} texts for {B_v} visuals x group {G}")
    out = clipbert.clipbert_forward(
        model, cfg, {"text_input_ids": batch["text_input_ids"].repeat(nc, 1),
                     "text_input_mask": batch["text_input_mask"].repeat(nc, 1)},
        ts.head_type, compute_dtype=compute_dtype, visual_features=feats,
        fused_attn=fused_attn, train=train, rngs=rngs, remat=remat,
        mesh=mesh)
    logits = out["logits"]                                  # (nc * B_t, L)
    if ts.head_type == "multi_choice":
        logits = logits.reshape(nc, B_t // ts.num_labels, ts.num_labels)
    else:
        logits = logits.reshape(nc, B_t, -1)
    return logits.transpose(0, 1)


def mil_forward_train(model: clipbert.ClipBert, cfg: ModelConfig,
                      ts: TaskSettings, batch: Dict[str, torch.Tensor],
                      rngs: Optional[RngGen],
                      compute_dtype=torch.bfloat16,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The train form of :func:`mil_forward` (clipbert_tpu/train/steps.py:
    116-165 with train=True), under autograd: dropout from ``rngs``,
    ``ts.remat``, and the plain forms passed explicitly (use_kernels=False,
    fused_attn=False) whatever the device, as the JAX train step runs the
    XLA CNN and the einsum core. A tensor-parallel ``mesh`` runs the
    encoder on this rank's Megatron shards (bert.encoder)."""
    return _mil_forward(model, cfg, ts, batch, compute_dtype,
                        use_kernels=False, fused_attn=False, train=True,
                        rngs=rngs, remat=ts.remat, mesh=mesh)


@torch.inference_mode()
def mil_forward(model: clipbert.ClipBert, cfg: ModelConfig,
                ts: TaskSettings, batch: Dict[str, torch.Tensor],
                compute_dtype=torch.bfloat16,
                use_kernels: Optional[bool] = None,
                fused_attn: bool = False) -> torch.Tensor:
    """All ``ts.train_n_clips`` clips through CNN + BERT as one batch, eval
    only (clipbert_tpu/train/steps.py:116-165 with train=False: no dropout).

    batch["visual_inputs"]: (B_v, nc * nf, H, W, 3); batch["text_input_ids"]
    and ["text_input_mask"]: (B_t, Lt) with B_t = B_v * group_size. Visuals
    fold clip-major, (B_v, nc * nf) -> (nc * B_v, nf), and the texts tile
    once per clip, so row c * B_t + t pairs clip c with text t. Returns
    per-clip logits (B', nc, L): B' = B_t, except for multi_choice, whose
    options are consecutive texts with one logit each, folded into the
    label axis: B' = B_t / num_labels questions of num_labels options.

    ``use_kernels`` as in clipbert.cnn_forward. ``fused_attn`` picks the
    attention core; the default is the einsum core, as in the JAX bench
    unit (bench.py:81-86)."""
    return _mil_forward(model, cfg, ts, batch, compute_dtype, use_kernels,
                        fused_attn)


def aggregate_clips(logits: torch.Tensor, agg: str) -> torch.Tensor:
    """(B, nc, L) -> (B, L) for mean / max clip pooling."""
    if agg == "mean":
        return logits.mean(dim=1)
    if agg == "max":
        return logits.amax(dim=1)
    raise ValueError(f"aggregate_clips called with {agg}")


def lse_pooled_logits(logits: torch.Tensor) -> torch.Tensor:
    """Eval-time LSE pooling over the clip axis
    (run_video_retrieval.py:668-677)."""
    return torch.logsumexp(logits.float(), dim=1)


def pool_clip_logits(logits: torch.Tensor, agg: str) -> torch.Tensor:
    """Eval pooling for all three agg functions; (B, nc, L) -> (B, L)."""
    if agg == "lse":
        return lse_pooled_logits(logits)
    return aggregate_clips(logits, agg)


def lse_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE over LSE-pooled clip logits (run_video_retrieval.py:415-418):
    loss[b] = LSE_{t,l}(logits[b]) - LSE_t(logits[b, :, label_b])."""
    logits = logits.float()
    B = logits.shape[0]
    all_lse = torch.logsumexp(logits.reshape(B, -1), dim=-1, keepdim=True)
    per_label = torch.logsumexp(logits, dim=1)              # (B, L)
    out = all_lse - per_label
    return torch.gather(out, -1, labels.reshape(-1, 1).long())[:, 0]


def task_loss(cfg: ModelConfig, ts: TaskSettings,
              batch: Dict[str, torch.Tensor], clip_logits: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, nc, L) per-clip logits + labels -> (scalar loss, metrics)."""
    labels = batch["labels"]
    metrics: Dict[str, torch.Tensor] = {}
    if ts.score_agg_func == "lse":
        loss = lse_loss(clip_logits, labels).mean()
        pooled = lse_pooled_logits(clip_logits)
    else:
        pooled = aggregate_clips(clip_logits, ts.score_agg_func)
        if ts.head_type == "retrieval" and ts.loss_type == "rank":
            sample_size = batch["visual_inputs"].shape[0]
            loss = clipbert.retrieval_rank_loss(
                pooled, sample_size, ts.margin).mean()
        elif ts.head_type == "multi_choice":
            loss = clipbert.cross_entropy(pooled, labels).mean()
        elif ts.num_labels == 1:
            # single-logit heads regress whatever the loss_type (reference
            # modeling.py calc_loss: num_labels == 1 -> MSELoss)
            loss = clipbert.mse(pooled, labels).mean()
        elif ts.loss_type == "bce":
            loss = clipbert.bce_with_logits(pooled, labels).mean()
            if ts.scale_loss_by_num_labels:
                loss = loss * ts.num_labels   # run_vqa.py:355-356
        else:
            loss = clipbert.cross_entropy(
                pooled.reshape(-1, pooled.shape[-1]),
                labels.reshape(-1)).mean()
    if ts.head_type != "retrieval" and ts.loss_type != "bce" \
            and pooled.dim() == 2 and pooled.shape[-1] > 1 \
            and labels.dim() == 1:
        metrics["acc"] = (pooled.argmax(-1) == labels).float().mean()
    return loss, metrics


# metrics that are ratios of counts over the batch -> (numerator,
# denominator) keys compute_loss returns beside them: a data-parallel step
# sums each count over the ranks before it divides, as the JAX step divides
# over the global batch (clipbert_tpu/train/steps.py:263-264). The counts
# never leave the step.
RATIO_METRICS = {"mlm_acc": ("mlm_correct", "mlm_valid")}
_COUNT_KEYS = frozenset(k for pair in RATIO_METRICS.values() for k in pair)


def pretrain_loss(cfg: ModelConfig, ts: TaskSettings,
                  model: clipbert.ClipBert, batch: Dict[str, torch.Tensor],
                  rngs: Optional[RngGen], train: bool, compute_dtype,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """mlm_loss.mean() + itm_loss.mean() (run_pretrain.py:387-395) with the
    MLM token and ITM accuracies (and the MLM counts, RATIO_METRICS); the
    plain forms, as mil_forward_train."""
    out = clipbert.clipbert_forward(
        model, cfg, batch, "pretrain", compute_dtype=compute_dtype,
        group_size=ts.group_size, train=train, rngs=rngs,
        remat=ts.remat if train else False, use_kernels=False,
        fused_attn=False, mesh=mesh)
    losses = clipbert.pretrain_losses(
        cfg, out,
        batch.get("mlm_labels") if ts.use_mlm else None,
        batch.get("itm_labels") if ts.use_itm else None)
    total = torch.zeros((), dtype=torch.float32,
                        device=batch["text_input_ids"].device)
    metrics: Dict[str, torch.Tensor] = {}
    if "mlm_loss" in losses:
        mlm = losses["mlm_loss"].mean()
        metrics["mlm_loss"] = mlm
        # MLM token accuracy over masked positions (run_pretrain.py:231-241)
        mlm_labels = batch["mlm_labels"].reshape(-1).long()
        valid = mlm_labels != -100
        pred = out["mlm_scores"].reshape(-1, cfg.vocab_size).argmax(-1)
        correct = torch.where(valid, pred == mlm_labels, False).sum()
        metrics["mlm_acc"] = correct / valid.sum().clamp(min=1)
        metrics["mlm_correct"] = correct.float()
        metrics["mlm_valid"] = valid.sum().float()
        total = total + mlm
    if "itm_loss" in losses:
        itm = losses["itm_loss"].mean()
        metrics["itm_loss"] = itm
        itm_labels = batch["itm_labels"].reshape(-1)
        pred = out["itm_scores"].argmax(-1)
        metrics["itm_acc"] = (pred == itm_labels).float().mean()
        total = total + itm
    return total, metrics


def compute_loss(model: clipbert.ClipBert, cfg: ModelConfig,
                 ts: TaskSettings, batch: Dict[str, torch.Tensor],
                 step_seed: Optional[int], train: bool,
                 compute_dtype=torch.bfloat16,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one (micro-)batch and its metrics; ``step_seed`` seeds
    the step's dropout (core/rng.py) when ``train``; a tensor-parallel
    ``mesh`` as in mil_forward_train."""
    rngs = RngGen(step_seed if train else None,
                  batch["text_input_ids"].device)
    if ts.head_type == "pretrain":
        return pretrain_loss(cfg, ts, model, batch, rngs, train,
                             compute_dtype, mesh)
    if train:
        clip_logits = mil_forward_train(model, cfg, ts, batch, rngs,
                                        compute_dtype, mesh)
    else:
        clip_logits = _mil_forward(model, cfg, ts, batch, compute_dtype,
                                   use_kernels=False, fused_attn=False,
                                   mesh=mesh)
    return task_loss(cfg, ts, batch, clip_logits)


# elements per flat buffer of the data-parallel gradient all-reduce
# (128 MiB of fp32): the BERT-base + ResNet-50 model's ~135M trainable
# elements go in 5 calls
GRAD_BUCKET_NUMEL = 1 << 25


def _all_reduce_mean(grads: Dict[str, torch.Tensor], mesh: Mesh) -> None:
    """``grads`` (fp32) averaged over the data group, in place of the
    dict's values: the leaves are packed into flat buffers of at most
    GRAD_BUCKET_NUMEL elements (one leaf larger than that gets its own),
    each all-reduced (SUM) once and divided by ``n_data``."""
    names, buckets, size = list(grads), [[]], 0
    for n in names:
        k = grads[n].numel()
        if buckets[-1] and size + k > GRAD_BUCKET_NUMEL:
            buckets.append([])
            size = 0
        buckets[-1].append(n)
        size += k
    for bucket in buckets:
        flat = torch.cat([grads[n].reshape(-1) for n in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
        flat.div_(mesh.n_data)
        for n, part in zip(bucket, flat.split([grads[n].numel()
                                               for n in bucket])):
            grads[n] = part.view_as(grads[n])


def _reduce_micro_metrics(per_micro, mesh: Mesh):
    """Each micro-batch's (loss, metrics) of this rank -> those of the
    global micro-batch over the data group, in one all-reduce: the loss
    and plain means averaged over the (equal) shards, a RATIO_METRICS
    ratio divided from its summed counts."""
    keys = sorted(per_micro[0][1])
    rows = torch.stack([torch.stack([l.float()] + [m[k].float()
                                                    for k in keys])
                        for l, m in per_micro])
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=mesh.data_group)
    out = []
    for row in rows:
        vals = dict(zip(keys, row[1:]))
        metrics = {k: v / mesh.n_data for k, v in vals.items()}
        for k, (num, den) in RATIO_METRICS.items():
            if k in vals:
                metrics[k] = vals[num] / vals[den].clamp(min=1)
        out.append((row[0] / mesh.n_data, metrics))
    return out


def make_train_step(cfg: ModelConfig, ts: TaskSettings, oc: OptimConfig,
                    ss: ScheduleSettings, meta: Dict[str, optim.GroupMeta],
                    accum_steps: int = 1,
                    compute_dtype=torch.bfloat16,
                    mesh: Optional[Mesh] = None) -> Callable:
    """The train step: step(state, batch, step_seed) -> (state, metrics),
    updating ``state`` in place. With ``accum_steps`` > 1 every batch
    tensor carries a leading (accum_steps, ...) micro-batch axis; each
    micro-batch's gradients add into the fp32 ``.grad`` (from zero) and
    the sum is divided by ``accum_steps``, the loss and metrics averaged,
    as the JAX step's scan does (clipbert_tpu/train/steps.py:315-333). The
    micro-batches' dropout seeds are derived from ``step_seed``. The
    schedules are evaluated at the post-increment step ``opt.step + 1``
    (run_video_qa.py:515-525). Metrics are device tensors (no sync) plus
    the two lrs.

    Under a ``mesh`` (core/mesh.py) the step is one replica of the JAX
    step on a global batch (clipbert_tpu/train/steps.py:292-366 with
    ``mesh=`` and ``state_shardings``), written as its collectives:

     - data axis: ``batch`` is this rank's shard of the global batch (each
       rank the same size). Each rank accumulates its gradients as above;
       then the fp32 gradients are all-reduced once per update over
       ``mesh.data_group`` in a few flat buffers and divided by
       ``n_data``, and the metrics of each micro-batch are reduced to the
       global micro-batch's (:func:`_reduce_micro_metrics`). Clipping, the
       norm and AdamW then run on identical gradients on every rank. With
       more than one data rank the dropout seeds fold in the rank's data
       index, so ranks draw different masks for different examples.
     - model axis: the model holds this rank's Megatron shards
       (parallel/sharding.py::shard_model), and so do the moments
       (:func:`init_train_state` after the cut). The forward's
       collectives carry their gradients (ops/linear.py), and the global
       norm sums the split leaves' squares over ``mesh.model_group``,
       counting each replicated leaf once.

    Overlapping the gradient all-reduce with the backward is not done
    (ROADMAP)."""
    data_parallel = mesh is not None and dist.is_initialized()
    model_parallel = mesh is not None and mesh.n_model > 1

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             step_seed: int):
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if data_parallel and mesh.n_data > 1:
            step_seed = derive_seed(step_seed, mesh.data_idx)
        per_micro = []              # each micro-batch's (loss, metrics)
        with torch.enable_grad():
            for i in range(accum_steps):
                mb = batch if accum_steps == 1 else \
                    {k: v[i] for k, v in batch.items()}
                seed = step_seed if accum_steps == 1 else \
                    derive_seed(step_seed, i)
                l, m = compute_loss(model, cfg, ts, mb, seed, True,
                                    compute_dtype, mesh)
                l.backward()
                per_micro.append((l.detach(),
                                  {k: v.detach() for k, v in m.items()}))
        grads = {}
        for n, p in params.items():
            if not meta[n].trainable:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g / accum_steps if accum_steps > 1 else g
            p.grad = None
        if data_parallel:
            _all_reduce_mean(grads, mesh)
            per_micro = _reduce_micro_metrics(per_micro, mesh)
        per_micro = [(l, {k: v for k, v in m.items()
                          if k not in _COUNT_KEYS}) for l, m in per_micro]
        if accum_steps == 1:
            loss, metrics = per_micro[0]
        else:
            lsum = 0.0
            for l, _ in per_micro:
                lsum = lsum + l
            loss = lsum / accum_steps
            metrics = {k: torch.stack([m[k].float()
                                       for _, m in per_micro]).mean()
                       for k in per_micro[0][1]}
        lr_t, lr_c = ss.lrs(state.opt.step + 1)
        split = None
        if model_parallel:
            split = (frozenset(n for n in grads if tp_split_dim(n)
                               is not None), mesh.model_group)
        # the group-fused form unless ``split`` is set, as the JAX step
        # passes fused=state_shardings is None
        grad_norm = optim.adamw_update(params, grads, state.opt, meta, oc,
                                       lr_t, lr_c, split=split)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm,
                       lr=float(lr_t), cnn_lr=float(lr_c))
        return state, metrics

    return step


def make_visual_encode_step(compute_dtype=torch.bfloat16,
                            use_kernels: Optional[bool] = None) -> Callable:
    """(model, pixels (B, T, H, W, 3)) -> grid features (B, T, Hg, Wg, D).
    ``use_kernels=None`` runs the CNN's kernel form (the fused stem and the
    fused 1x1 convs) when the pixels lie on a CUDA device."""

    @torch.inference_mode()
    def step(model: clipbert.ClipBert, pixels: torch.Tensor) -> torch.Tensor:
        return clipbert.cnn_forward(model.cnn, pixels, compute_dtype,
                                    use_kernels)

    return step


def fused_attn_default(device: torch.device, mesh: Optional[Mesh] = None,
                       num_heads: int = 12) -> bool:
    """Whether the scoring steps run the attention core through the fused
    kernel (clipbert_tpu/train/steps.py:459-490). The kernel runs where
    ops.kernels_default puts the port's kernels: on a CUDA device. A
    data-parallel mesh runs the whole step per rank on its caption shard,
    and a tensor-parallel one runs the kernel on each rank's heads
    (ops/fused_attention.py::fused_attention_shard_heads), or takes einsum
    when the heads do not split over its model axis. Where the JAX
    selector returns the tensor-parallel mesh itself, this returns True:
    the mesh reaches the attention core on its own argument."""
    if not kernels_default(device):
        return False
    return mesh is None or num_heads % mesh.n_model == 0


def _data_shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows on the data axis."""
    n = mesh.n_data
    if x.shape[0] % n:
        raise ValueError(f"caption minibatch of {x.shape[0]} does not split "
                         f"over the {n} data ranks of the mesh")
    w = x.shape[0] // n
    return x[mesh.data_idx * w:(mesh.data_idx + 1) * w]


def make_text_score_step(cfg: ModelConfig, ts: TaskSettings,
                         compute_dtype=torch.bfloat16,
                         fused_attn: Optional[bool] = None,
                         mesh: Optional[Mesh] = None) -> Callable:
    """(model, feats (B_v, nc, T, Hg, Wg, D), ids (B_t, Lt), mask) ->
    (B_v, B_t, nc, L) logits: every (video, clip) paired with every text in
    one BERT batch of B_v*nc*B_t sequences. ``fused_attn=None`` takes
    :func:`fused_attn_default`. Under a tensor-parallel ``mesh`` the model
    holds this rank's Megatron shards (parallel/sharding.py::shard_model)
    and scores the captions it is given; make_text_prob_step splits the
    captions over the data axis."""

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        fused = (fused_attn_default(feats.device, mesh,
                                    cfg.num_attention_heads)
                 if fused_attn is None else fused_attn)
        B_v, nc = feats.shape[:2]
        B_t = ids.shape[0]
        f = feats.reshape((B_v * nc,) + feats.shape[2:])
        f = f.repeat_interleave(B_t, dim=0)
        out = clipbert.clipbert_forward(
            model, cfg,
            {"text_input_ids": ids.repeat(B_v * nc, 1),
             "text_input_mask": mask.repeat(B_v * nc, 1)},
            ts.head_type, compute_dtype=compute_dtype, visual_features=f,
            fused_attn=fused, mesh=mesh)
        return out["logits"].reshape(B_v, nc, B_t, -1).transpose(1, 2)

    return step


def make_text_prob_step(cfg: ModelConfig, ts: TaskSettings,
                        compute_dtype=torch.bfloat16,
                        fused_attn: Optional[bool] = None,
                        mesh: Optional[Mesh] = None) -> Callable:
    """Like make_text_score_step plus clip pooling and softmax/sigmoid:
    (B_v, B_t) fp32 positive-class probabilities
    (run_video_retrieval.py:679-682).

    With a ``mesh`` every rank is given the whole caption minibatch (B_t
    must split over the data axis, as the JAX step requires), scores its
    data shard, and the (B_v, B_t / n_data) shards are gathered over the
    data group in data order, so every rank returns what the JAX step's
    global array holds.

    Without a mesh, this step, make_videoqa_prob_step,
    make_qa_answer_step and make_visual_encode_step make no host sync and
    no host-to-device copy, so the scorers capture them in CUDA graphs
    (serve.py); the mesh branch's all_gather is never captured (no scorer
    takes a mesh)."""
    score = make_text_score_step(cfg, ts, compute_dtype, fused_attn, mesh)

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        if mesh is not None:
            ids, mask = _data_shard(ids, mesh), _data_shard(mask, mesh)
        clip_logits = score(model, feats, ids, mask)   # (B_v, B_t, nc, L)
        B_v, B_t = clip_logits.shape[:2]
        pooled = pool_clip_logits(
            clip_logits.reshape((-1,) + clip_logits.shape[2:]),
            ts.score_agg_func).float().reshape(B_v, B_t, -1)
        if ts.loss_type == "ce":
            probs = torch.softmax(pooled, dim=-1)[..., 1]
        else:
            probs = torch.sigmoid(pooled[..., 0])
        if mesh is None or mesh.n_data == 1:
            return probs
        parts = [torch.empty_like(probs) for _ in range(mesh.n_data)]
        dist.all_gather(parts, probs.contiguous(), group=mesh.data_group)
        return torch.cat(parts, dim=1)

    return step


def _fused(fused_attn: Optional[bool], device: torch.device,
           cfg: ModelConfig) -> bool:
    return (fused_attn_default(device, None, cfg.num_attention_heads)
            if fused_attn is None else fused_attn)


def make_eval_step(cfg: ModelConfig, ts: TaskSettings,
                   compute_dtype=torch.bfloat16,
                   fused_attn: Optional[bool] = None,
                   use_kernels: Optional[bool] = None) -> Callable:
    """Forward-only step: (model, batch) -> {"clip_logits" (B', nc, L),
    "logits": pooled over clips by ts.score_agg_func}.

    ``fused_attn=None`` takes :func:`fused_attn_default`: the fused kernel
    on a CUDA device. (The JAX step runs the einsum core here on purpose,
    from a TPU measurement; the port keeps its one routing rule, and
    chip_smoke.py times the two cores on this step.) ``use_kernels`` as in
    clipbert.cnn_forward."""

    @torch.inference_mode()
    def step(model, batch):
        fused = _fused(fused_attn, batch["visual_inputs"].device, cfg)
        clip_logits = mil_forward(model, cfg, ts, batch, compute_dtype,
                                  use_kernels, fused_attn=fused)
        return {"clip_logits": clip_logits,
                "logits": pool_clip_logits(clip_logits, ts.score_agg_func)}

    return step


def make_pretrain_eval_step(cfg: ModelConfig, ts: TaskSettings,
                            compute_dtype=torch.bfloat16,
                            fused_attn: Optional[bool] = None,
                            use_kernels: Optional[bool] = None) -> Callable:
    """Validation forward for pretraining: (model, batch) -> the mlm / itm
    scores, ``pooled_output`` and the per-element ``mlm_loss`` /
    ``itm_loss`` of the labels the batch carries (as ts.use_mlm /
    ts.use_itm allow). The kernels run on a CUDA device
    (:func:`fused_attn_default`, clipbert.cnn_forward); ``fused_attn`` and
    ``use_kernels`` as in :func:`make_eval_step`."""

    @torch.inference_mode()
    def step(model, batch):
        fused = _fused(fused_attn, batch["visual_inputs"].device, cfg)
        out = clipbert.clipbert_forward(
            model, cfg, batch, "pretrain", compute_dtype=compute_dtype,
            group_size=ts.group_size, fused_attn=fused,
            use_kernels=use_kernels)
        losses = clipbert.pretrain_losses(
            cfg, out,
            batch.get("mlm_labels") if ts.use_mlm else None,
            batch.get("itm_labels") if ts.use_itm else None)
        return {**out, **losses}

    return step


def make_videoqa_prob_step(cfg: ModelConfig, ts: TaskSettings,
                           compute_dtype=torch.bfloat16,
                           fused_attn: Optional[bool] = None) -> Callable:
    """(model, feats (1, nc, T, Hg, Wg, D), ids (B_t, Lt), mask) -> answer
    probabilities for one cached video with the video-QA protocol's clip
    handling (run_video_qa.py:216-362: per-clip logits pooled by
    score_agg_func). Two head shapes:

     - seq_cls (open-ended frameqa / msrvtt_qa): B_t questions, softmax
       over the answer vocabulary -> (B_t, num_labels);
     - multi_choice (action / transition): B_t = n_q * num_labels
       question + option texts with one logit each; softmax over each
       question's option block -> (n_q, num_labels).

    ``fused_attn`` as in :func:`make_text_score_step`."""
    score = make_text_score_step(cfg, ts, compute_dtype, fused_attn)

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        clip_logits = score(model, feats, ids, mask)[0]     # (B_t, nc, L)
        pooled = pool_clip_logits(clip_logits, ts.score_agg_func).float()
        if ts.head_type == "multi_choice":
            pooled = pooled.reshape(-1, ts.num_labels)      # (n_q, options)
        return torch.softmax(pooled, dim=-1)

    return step


def make_qa_answer_step(cfg: ModelConfig, ts: TaskSettings,
                        compute_dtype=torch.bfloat16,
                        fused_attn: Optional[bool] = None) -> Callable:
    """(model, feats (1, T, Hg, Wg, D), ids (B_q, Lt), mask) -> (B_q,
    num_labels) fp32 answer probabilities for one cached visual: the
    serving unit of VQA / open-ended QA (sigmoid over a bce head, as the
    reference's VQA protocol, run_vqa.py:347-356; softmax over a ce head).
    The one visual fans out to every question through ``group_size``.
    ``fused_attn`` as in :func:`make_text_score_step`."""

    @torch.inference_mode()
    def step(model, feats, ids, mask):
        fused = _fused(fused_attn, feats.device, cfg)
        out = clipbert.clipbert_forward(
            model, cfg, {"text_input_ids": ids, "text_input_mask": mask},
            "seq_cls", compute_dtype=compute_dtype, visual_features=feats,
            group_size=ids.shape[0], fused_attn=fused)
        logits = out["logits"].float()
        if ts.loss_type == "bce":
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)

    return step
