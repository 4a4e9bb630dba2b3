"""The single trainer engine (port of clipbert_tpu/train/trainer.py).

Task runners supply a :class:`TaskSpec` with their loader, step settings
and a validation callable; the loop is shared. Per-step semantics of the
reference loop (e.g. run_video_qa.py:455-560): running-loss EMA,
schedule-derived per-group lrs, grad-norm logging, periodic restorer save,
validation + deployment checkpoint every ``valid_steps``, debug truncation
(config.py:45-48).

The train step updates the model in place and returns device metrics; the
loop fetches them one step late, so the host never waits on the step it
has just launched. Batches come from loader.PrefetchLoader, already on the
device. Checkpoints are written in the JAX package's ``.npz`` key scheme
(ckpt/from_jax.py::to_jax_flat) by the shared async writer: the JAX
package resumes the port's bundles and the port resumes the JAX package's.

Under a process group (core/mesh.py::maybe_init_distributed) the loop
trains data-parallel, as the JAX trainer does over its mesh's data axis:
each process loads its ``train_batch_size`` share of the global batch
(tasks/common.py::build_train_loader), the step all-reduces the gradients
over the data group (train/steps.py::make_train_step with ``mesh``), the
weights start from process 0's (broadcast, then checked bit for bit on
every process), validation shards over the processes and merges, and
only the main process writes (meta, logs, checkpoints, restore bundles).
Every process restores the bundle on auto-resume, and then takes process
0's weights, moments and step counts; a stop requested on any process
stops every process at the same step.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from clipbert_tpu_torch.ckpt import checkpoint, torch_import
from clipbert_tpu_torch.ckpt.from_jax import (load_jax_params, model_state,
                                              port_values, to_jax_flat)
from clipbert_tpu_torch.core.config import ModelConfig, RunConfig
from clipbert_tpu_torch.core.mesh import make_mesh
from clipbert_tpu_torch.core.rng import derive_seed
from clipbert_tpu_torch.data import transforms
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks.common import device_for
from clipbert_tpu_torch.train import optim, steps
from clipbert_tpu_torch.utils import distributed as dist
from clipbert_tpu_torch.utils.logger import (LOGGER, TB_LOGGER, NoOp,
                                             RunningMeter)
from clipbert_tpu_torch.utils.profiling import StepTimer, TraceWindow

@dataclass
class TaskSpec:
    """Everything task-specific the engine needs."""

    name: str
    head_type: str
    settings: steps.TaskSettings
    train_loader: Any                       # iterable of batches
    steps_per_epoch: int
    # validate(model, eval_step_fn) -> metrics dict
    validate_fn: Optional[Callable] = None
    mean: tuple = transforms.IMAGENET_MEAN_255
    std: tuple = transforms.IMAGENET_STD_1
    max_img_size: int = 448       # device-preprocess resize target


def optim_config_from_run(cfg: RunConfig) -> optim.OptimConfig:
    return optim.OptimConfig(
        optim=cfg.optim,
        learning_rate=cfg.learning_rate,
        cnn_learning_rate=cfg.cnn_learning_rate,
        weight_decay=cfg.weight_decay,
        cnn_weight_decay=cfg.cnn_weight_decay,
        betas=tuple(cfg.betas),
        grad_norm=cfg.grad_norm,
        transformer_lr_mul=cfg.transformer_lr_mul,
        transformer_lr_mul_prefix=cfg.transformer_lr_mul_prefix,
        cnn_lr_mul=cfg.cnn_lr_mul,
        cnn_lr_mul_prefix=cfg.cnn_lr_mul_prefix,
        freeze_cnn=cfg.freeze_cnn)


def schedule_from_run(cfg: RunConfig, num_train_steps: int,
                      steps_per_epoch: int) -> steps.ScheduleSettings:
    return steps.ScheduleSettings(
        learning_rate=cfg.learning_rate,
        cnn_learning_rate=cfg.cnn_learning_rate,
        decay=cfg.decay, cnn_decay=cfg.cnn_lr_decay,
        num_train_steps=num_train_steps,
        warmup_ratio=cfg.warmup_ratio,
        step_decay_epochs=(tuple(cfg.step_decay_epochs)
                           if cfg.step_decay_epochs else None),
        cnn_step_decay_epochs=(tuple(cfg.cnn_step_decay_epochs)
                               if cfg.cnn_step_decay_epochs else None),
        steps_per_epoch=steps_per_epoch)


# ---------------------------------------------------------------------------
# model setup (reference setup_model, e.g. run_video_qa.py:152-205)
# ---------------------------------------------------------------------------

# _load_flat_ckpt, _is_tf_checkpoint and import_torch_e2e are copied from
# clipbert_tpu/train/trainer.py (tests/test_torch_host_copies.py holds them
# to it)

def _load_flat_ckpt(path: str) -> Dict[str, np.ndarray]:
    """A flat {name: np.array} dict from a .npz (either package's) or a
    torch checkpoint (.pt / .pth / .bin: a state_dict, or a dict holding
    one under "model")."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and \
            isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _is_tf_checkpoint(path: str) -> bool:
    """TF-1 checkpoint prefix: its `<prefix>.index` file must exist (given
    directly or implied). No name heuristics: torch checkpoints are also
    commonly named `*.ckpt` and must route to torch.load."""
    return path.endswith(".index") or os.path.exists(path + ".index")


def _merge_subtree(flat: Dict[str, np.ndarray], prefix: str, tree: Dict
                   ) -> Dict[str, List[str]]:
    """Merge an imported subtree into the flat JAX tree ``flat`` under
    ``prefix`` (``"cnn/resnet/"``), in place, by name and shape
    (checkpoint.load_with_mismatch); returns the merge report."""
    sub = {k[len(prefix):]: v for k, v in flat.items()
           if k.startswith(prefix)}
    merged, report = checkpoint.load_with_mismatch(
        sub, checkpoint.flatten_tree(tree))
    flat.update((prefix + k, v)
                for k, v in checkpoint.flatten_tree(merged).items())
    return report


def setup_model(run_cfg: RunConfig, model_cfg: ModelConfig, head_type: str,
                device: torch.device | str,
                seed: Optional[int] = None,
                strict: bool = False) -> clipbert.ClipBert:
    """The seeded random init on ``device``; then the e2e weights OR the
    separate CNN / BERT weights, each merged by name and shape
    (checkpoint.load_with_mismatch; e2e_model.py:41-46,
    run_video_qa.py:185-198), as clipbert_tpu/train/trainer.py::
    setup_model does:

     - ``e2e_weights_path``: a flat ``.npz`` in the JAX key scheme (either
       package's deploy checkpoint), or the reference's e2e state_dict
       (``model_step_N.pt``, import_torch_e2e);
     - ``backbone_weights_path``: a torchvision or detectron2 ResNet-50;
     - ``bert_weights_path``: an HF BERT state_dict (``pytorch_model.bin``)
       or a TF-1 checkpoint prefix.

    The importers convert into the JAX tree (ckpt/torch_import.py), which
    loads into the port's modules through the weight bridge
    (ckpt/from_jax.py). A detectron2 stem trained on BGR input is flipped to
    take RGB here, once, when ``img_input_format`` is BGR; nothing
    downstream flips again. A checkpoint that does not read raises.

    ``strict`` (serving) takes every leaf of the model from
    ``e2e_weights_path``: a leaf the checkpoint lacks, or holds at another
    shape (a classifier of another width), raises instead of keeping its
    init, and the model is allocated uninitialized, not seeded."""
    path = run_cfg.e2e_weights_path
    if strict and not path:
        raise ValueError("a strict load needs e2e_weights_path")
    if strict:
        model = clipbert.empty_clipbert(model_cfg, head_type, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(
            run_cfg.seed if seed is None else seed)
        model = clipbert.init_clipbert(model_cfg, head_type, generator=gen,
                                       device=device)
    if not (path or run_cfg.backbone_weights_path
            or run_cfg.bert_weights_path):
        return model
    flat = to_jax_flat(model_state(model))
    bgr = run_cfg.img_input_format == "BGR"
    if path:
        LOGGER.info(f"Loading e2e weights from {path}")
        loaded = _load_flat_ckpt(path)
        if not any("/" in k for k in loaded):     # reference torch e2e
            loaded = checkpoint.flatten_tree(import_torch_e2e(
                loaded, model_cfg, head_type, bgr_checkpoint=bgr))
        merged, report = checkpoint.load_with_mismatch(flat, loaded)
        flat = checkpoint.flatten_tree(merged)
        LOGGER.info(f"e2e load report: missing={len(report['missing'])} "
                    f"mismatched={report['mismatched']}")
        if strict and (report["missing"] or report["mismatched"]):
            raise ValueError(
                f"{path} does not hold the whole {head_type} model: "
                f"missing {report['missing'][:8]} "
                f"({len(report['missing'])}), mismatched "
                f"{report['mismatched'][:8]}")
    else:
        if run_cfg.backbone_weights_path:
            LOGGER.info(
                f"Loading cnn weights from {run_cfg.backbone_weights_path}")
            loaded = _load_flat_ckpt(run_cfg.backbone_weights_path)
            if any(k.startswith(("layer1", "conv1")) for k in loaded):
                cnn = torch_import.import_resnet50_torchvision(loaded)
            else:
                cnn = torch_import.import_resnet50_d2(loaded,
                                                      bgr_checkpoint=bgr)
            report = _merge_subtree(flat, "cnn/resnet/", cnn)
            LOGGER.info(f"cnn load report: missing={len(report['missing'])} "
                        f"mismatched={report['mismatched']}")
        if run_cfg.bert_weights_path:
            bp = run_cfg.bert_weights_path
            LOGGER.info(f"Loading bert weights from {bp}")
            if _is_tf_checkpoint(bp):
                # TF-1 BERT checkpoint (the reference's from_tf load,
                # transformers.py:64-137)
                bert_tree = torch_import.import_bert_tf(
                    bp.removesuffix(".index"), model_cfg.num_hidden_layers)
                cls_tree = bert_tree.pop("cls", None)
                if cls_tree is not None and head_type == "pretrain":
                    _merge_subtree(flat, "transformer/cls/", cls_tree)
            else:
                loaded = _load_flat_ckpt(bp)
                loaded = {k.removeprefix("bert."): v
                          for k, v in loaded.items()}
                bert_tree = {
                    "embeddings":
                        torch_import.import_bert_text_embeddings(loaded),
                    "encoder": torch_import.import_bert_encoder(
                        loaded, model_cfg.num_hidden_layers),
                    "pooler": torch_import.import_bert_pooler(loaded),
                }
            _merge_subtree(flat, "transformer/bert/", bert_tree)
    load_jax_params(model, flat)
    return model


def import_torch_e2e(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                     head_type: str, bgr_checkpoint: bool = True) -> Dict:
    """Reference e2e ``model_step_N.pt`` state_dict -> the JAX parameter
    tree (clipbert_tpu/train/trainer.py::import_torch_e2e). Key scheme:
    cnn.backbone..., cnn.grid_encoder..., transformer.bert...,
    transformer.classifier / cls... (e2e_model.py:13-27)."""
    cnn_sd = torch_import.strip_prefix(flat, "cnn.")
    bert_sd = torch_import.strip_prefix(flat, "transformer.bert.")
    out: Dict = {
        "cnn": {
            "resnet": torch_import.import_resnet50_d2(
                cnn_sd, bgr_checkpoint=bgr_checkpoint),
            "grid_encoder": torch_import.import_grid_encoder(cnn_sd),
        },
        "transformer": {
            "bert": torch_import.import_clipbert_base(bert_sd, cfg)},
    }
    tsd = torch_import.strip_prefix(flat, "transformer.")
    if head_type == "pretrain":
        out["transformer"]["cls"] = torch_import.import_pretraining_heads(tsd)
    elif f"classifier.0.weight" in tsd:  # noqa: F541 (as copied)
        out["transformer"]["classifier"] = torch_import.import_mlp_head(tsd)
    return out


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def train(run_cfg: RunConfig, model_cfg: ModelConfig, spec: TaskSpec,
          max_steps: Optional[int] = None,
          stop_signal: Optional[Callable[[], bool]] = None
          ) -> Dict[str, Any]:
    """Run training to completion; returns {model, global_step, history,
    state, task_loss}.

    ``stop_signal`` (optional) is polled once per step; when it returns
    True the loop saves a restore bundle and exits cleanly, and the next
    run auto-resumes from it. When None, a SIGTERM handler provides the
    same behaviour (SIGTERM -> bundle -> resume)."""
    restore_sigterm = None
    if stop_signal is None:
        import signal
        flag = {"stop": False}

        def _on_term(signum, frame):
            flag["stop"] = True
            LOGGER.info("SIGTERM received: will checkpoint and exit "
                        "after this step")

        try:                       # signal.signal works in the main thread only
            prev = signal.signal(signal.SIGTERM, _on_term)
            restore_sigterm = (signal, prev)
        except ValueError:
            pass
        stop_signal = lambda: flag["stop"]  # noqa: E731
    try:
        return _train_loop(run_cfg, model_cfg, spec, max_steps, stop_signal)
    finally:
        if restore_sigterm is not None:
            sig, prev = restore_sigterm
            sig.signal(sig.SIGTERM, prev)


def _train_loop(run_cfg: RunConfig, model_cfg: ModelConfig, spec: TaskSpec,
                max_steps, stop_signal) -> Dict[str, Any]:
    run_cfg.validate()
    mesh = make_mesh() if torch.distributed.is_initialized() else None
    device = device_for(run_cfg)
    main = dist.is_main_process()
    tb = TB_LOGGER if main else NoOp()
    out_dir = run_cfg.output_dir
    if main and out_dir:
        # args.json + model_config.json + a code.zip snapshot of the port
        # package (reference save_training_meta, load_save.py:17-40)
        import clipbert_tpu_torch
        checkpoint.save_training_meta(
            out_dir, run_cfg.to_dict(), model_cfg.to_dict(),
            code_dir=os.path.dirname(os.path.abspath(
                clipbert_tpu_torch.__file__)))
        tb.create(os.path.join(out_dir, "log"))

    steps_per_epoch = max(1, spec.steps_per_epoch)
    num_train_steps = int(math.ceil(
        run_cfg.num_train_epochs * steps_per_epoch
        / run_cfg.gradient_accumulation_steps))
    if max_steps is not None:
        num_train_steps = min(num_train_steps, max_steps)
    if run_cfg.debug:
        num_train_steps = min(num_train_steps, 3)   # config.py:45-48
    # validate every ceil(steps/num_valid/min_valid)*min_valid steps, the
    # reference's rounding (run_vqa.py:302-304); debug validates every step
    min_valid = 1 if run_cfg.debug else max(run_cfg.min_valid_steps, 1)
    valid_steps = int(math.ceil(
        num_train_steps / max(run_cfg.num_valid, 1) / min_valid)) * min_valid
    valid_steps = max(valid_steps, 1)

    oc = optim_config_from_run(run_cfg)
    ss = schedule_from_run(run_cfg, num_train_steps, steps_per_epoch)
    model = setup_model(run_cfg, model_cfg, spec.head_type, device)
    meta = optim.build_group_meta(model, oc)
    groups = optim.count_groups(meta)
    # the reference asserts the 8-group structure (run_vqa.py:388); with an
    # empty lr_mul prefix the corresponding "top" groups are legally empty
    assert set(groups) <= set(range(-1, 8)), f"bad group ids: {groups}"

    compute_dtype = torch.bfloat16 if run_cfg.bf16 else torch.float32
    accum = run_cfg.gradient_accumulation_steps
    step_fn = steps.make_train_step(model_cfg, spec.settings, oc, ss, meta,
                                    accum_steps=accum,
                                    compute_dtype=compute_dtype, mesh=mesh)
    eval_fn = steps.make_eval_step(model_cfg, spec.settings,
                                   compute_dtype=compute_dtype) \
        if spec.head_type != "pretrain" else \
        steps.make_pretrain_eval_step(model_cfg, spec.settings,
                                      compute_dtype=compute_dtype)

    state = steps.init_train_state(model, meta)
    global_step = 0
    restorer = None
    if out_dir:
        restorer = checkpoint.TrainingRestorer(
            out_dir, save_steps=max(
                1, int(run_cfg.save_steps_ratio * num_train_steps)),
            async_write=True)
        resumed = restorer.restore()
        if resumed is not None:
            global_step, tree = resumed
            load_bundle(state, tree)
            LOGGER.info(f"resumed from restore bundle at step {global_step}")
    stop_group = None
    if mesh is not None:
        # every replica starts from process 0's weights, moments and update
        # counts, whichever bundle (or none) this process found
        global_step, state.opt.step = dist.broadcast_object(
            (global_step, state.opt.step))
        replica = replica_tensors(state)
        dist.broadcast_tensors(replica)
        dist.check_replicas_equal(
            replica + [torch.tensor([global_step, state.opt.step])],
            "initial weights and step counts")
        # the processes agree on a stop before acting on it (a host flag,
        # so over gloo: no device synchronization)
        if torch.distributed.get_backend() != "gloo":
            stop_group = torch.distributed.new_group(backend="gloo")
    # async: only the D2H copy blocks the loop; serialization and the disk
    # write run on the checkpoint writer thread (drained before return)
    saver = (checkpoint.ModelSaver(out_dir, async_write=True)
             if (main and out_dir) else None)

    running = RunningMeter("train_loss")
    history = []
    LOGGER.info(f"[{spec.name}] training for {num_train_steps} steps "
                f"({steps_per_epoch}/epoch), validating every {valid_steps}")
    t_start = time.time()
    timer = StepTimer()
    trace = TraceWindow(run_cfg.profile_dir if main else None)
    last_loss = float("nan")
    task_meters: Dict[str, RunningMeter] = {}

    def consume(pending):
        """Read a finished step's metrics (one step late, so the host never
        blocks the device pipeline on the step it just launched)."""
        nonlocal last_loss
        gs, metrics, task = pending
        last_loss = float(metrics["loss"])   # device sync point
        timer.stop()
        running(last_loss)
        tb.step()
        scalars = {"train_loss": last_loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "cnn_lr": float(metrics["cnn_lr"])}
        if task is not None:
            # per-task loss meters, as the reference's task2loss
            # RunningMeters (run_pretrain.py:384-395)
            meter = task_meters.setdefault(
                task, RunningMeter(f"loss_{task}"))
            meter(last_loss)
            scalars[f"loss_{task}"] = last_loss
        tb.log_scalar_dict(scalars, "train")

    def next_task_batch(it):
        """Loader items are batches, or (task_name, batch) pairs from a
        multi-task loader (task identity kept for logging)."""
        item = next(it)
        if isinstance(item, tuple) and len(item) == 2 \
                and isinstance(item[0], str):
            return item
        return None, item

    pending = None
    train_iter = iter(spec.train_loader)
    while global_step < num_train_steps:
        # a stop seen by any process stops every process at this step: one
        # that stopped alone would leave the others in a collective
        if dist.any_process(stop_signal(), stop_group):
            LOGGER.info(f"stop requested at step {global_step}: "
                        "saving restore bundle and exiting")
            if restorer is not None and main:
                restorer.save(global_step, restore_bundle(state))
            break
        trace.maybe_start(global_step)
        if accum == 1:
            task, host_batch = next_task_batch(train_iter)
            batch = _to_device_batch(host_batch, device, spec, compute_dtype)
        else:
            # one update consumes `accum` loader batches (the reference's
            # delay-unscale window, run_pretrain.py:398-404), stacked on a
            # leading micro-batch axis; the first micro's task names it
            pairs = [next_task_batch(train_iter) for _ in range(accum)]
            task = pairs[0][0]
            micros = [_to_device_batch(b, device, spec, compute_dtype)
                      for _, b in pairs]
            batch = {k: torch.stack([m[k] for m in micros])
                     for k in micros[0]}
        timer.start()
        state, metrics = step_fn(state, batch,
                                 derive_seed(run_cfg.seed, global_step))
        global_step += 1

        if pending is not None:
            consume(pending)
        pending = (global_step, metrics, task)
        trace.maybe_stop(global_step)

        sync_point = (global_step % valid_steps == 0
                      or global_step == num_train_steps
                      or (restorer is not None and main
                          and global_step % restorer.save_steps == 0))
        if not sync_point:
            continue
        consume(pending)
        pending = None

        if restorer is not None and main \
                and global_step % restorer.save_steps == 0:
            restorer.save(global_step, restore_bundle(state))

        if global_step % valid_steps == 0 or global_step == num_train_steps:
            elapsed = time.time() - t_start
            perf = timer.summary()
            LOGGER.info(f"step {global_step}/{num_train_steps} "
                        f"loss {last_loss:.4f} ({elapsed:.1f}s, "
                        f"{perf.get('steps_per_sec', 0):.2f} steps/s)")
            tb.log_scalar_dict(perf, "perf")
            entry = {"step": global_step, "loss": last_loss, **perf}
            if spec.validate_fn is not None:
                # on the live weights, unfolded, under inference_mode (the
                # eval steps'): validation changes no training tensor
                val_metrics = spec.validate_fn(state.model, eval_fn)
                tb.log_scalar_dict(
                    {k: v for k, v in val_metrics.items()
                     if isinstance(v, (int, float))}, "valid")
                entry["val"] = val_metrics
                LOGGER.info("validation: " + str(
                    {k: v for k, v in val_metrics.items()
                     if isinstance(v, (int, float))}))
            history.append(entry)
            if saver is not None:
                saver.save(global_step, to_jax_flat(model_state(state.model)))

    if pending is not None:
        consume(pending)
    trace.close()
    tb.flush()
    # every enqueued checkpoint write is durable before returning: the
    # SIGTERM path relies on the bundle being on disk when the process exits
    # (and, under a process group, before any process reads it again)
    checkpoint.drain_writes()
    dist.barrier()
    return {"model": state.model, "global_step": global_step,
            "history": history, "state": state,
            "task_loss": {t: m.val for t, m in task_meters.items()}}


def replica_tensors(state: steps.TrainState) -> List[torch.Tensor]:
    """What every data-parallel replica must hold alike: the model's
    parameters and buffers and the moments, in a fixed order."""
    return (list(model_state(state.model).values())
            + [state.opt.mu[n] for n in sorted(state.opt.mu)]
            + [state.opt.nu[n] for n in sorted(state.opt.nu)])


def restore_bundle(state: steps.TrainState) -> Dict:
    """The restore-bundle tree in the JAX schema (clipbert_tpu/train/
    trainer.py::_restore_bundle): {params, opt: {step, mu, nu}}, each tree
    flat in the JAX key scheme; the moments cover every leaf of the
    parameter tree, zero where a leaf does not train, as the JAX optimizer
    allocates them."""
    tensors = model_state(state.model)
    opt = state.opt

    def moments(m):
        return to_jax_flat({n: m[n] if n in m else torch.zeros_like(t)
                            for n, t in tensors.items()})

    return {"params": to_jax_flat(tensors),
            "opt": {"step": np.asarray(opt.step, np.int32),
                    "mu": moments(opt.mu), "nu": moments(opt.nu)}}


@torch.no_grad()
def load_bundle(state: steps.TrainState, tree: Dict) -> None:
    """A restore bundle's state tree (either package's) into ``state`` in
    place: the weights, the update count and the trainable parameters'
    moments."""
    load_jax_params(state.model, tree["params"])
    state.opt.step = int(np.asarray(tree["opt"]["step"]))
    for key in ("mu", "nu"):
        values = port_values(tree["opt"][key])
        dst = getattr(state.opt, key)
        for n, t in dst.items():
            t.copy_(torch.from_numpy(values[n]))


def _to_device_batch(batch: Dict, device: torch.device, spec: TaskSpec,
                     compute_dtype) -> Dict:
    """A batch -> device tensors, pixels normalized on the device. Tensors
    already there (PrefetchLoader's) pass through; other numeric arrays
    move; non-numeric values are dropped."""
    dev = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            dev[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        elif isinstance(v, torch.Tensor):
            dev[k] = v.to(device)
    if "visual_src_hw" in dev:
        dev["visual_inputs"] = transforms.resize_pad_normalize(
            dev["visual_inputs"], dev.pop("visual_src_hw"),
            spec.max_img_size, spec.mean, spec.std, compute_dtype)
    elif "visual_inputs" in dev and dev["visual_inputs"].dtype == torch.uint8:
        dev["visual_inputs"] = transforms.normalize_pixels(
            dev["visual_inputs"], spec.mean, spec.std, compute_dtype)
    return dev
