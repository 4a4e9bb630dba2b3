"""Convergence-length pretraining on one card with a SIGTERM and an
auto-resume mid-run (port of scripts/train_convergence_tpu.py).

    python -m clipbert_tpu_torch.train_convergence [--steps 100]
        [--device cuda] [--deadline_s S]
    python -m clipbert_tpu_torch.train_convergence --smoke --steps 8

Runs ``--steps`` updates of the PRETRAIN loop (tasks/run_pretrain.py::
start_training: MLM + ITM summed, the MetaLoader, the 8-group AdamW, the
restore bundles; the reference hot loop run_pretrain.py:384-476) at the
real train shape (BERT-base + R50 at 448^2, bf16, 8 videos x 2 frames a
step) on a synthetic corpus: 8 solid-colour striped videos, 4 captions
each with a predictable prefix and repeated colour words, the tiny
vocabulary, a constant lr of 1e-3 (5e-3 for ``--smoke``), a restore bundle
every 26% of the run (``save_steps_ratio`` 0.26).

The orchestrator launches a worker process, which stops after the update
two past the first restore bundle and waits there; it sends the worker a
SIGTERM (the trainer's own handler saves a bundle at that step and exits),
relaunches it, which auto-resumes and runs to the end, and checks:
``resumed_step`` equals the step at the SIGTERM; ``descends``: the
smoothed final loss above the ln 2 ITM floor is under 0.6x the first
loss's (the ITM half stays at its chance floor from random init at this
horizon; MLM is what descends); ``resume_continues``: the state the
resumed worker loaded is bit for bit the one phase A saved at the SIGTERM
(``restored_state_matches``: a sha256 of the weights, the moments and the
update count, taken as the bundle is made and again after it is loaded; a
restart from scratch loads nothing), and the first loss after the resume
is within 1.25x (+0.05) of the smoothed loss at the SIGTERM. The step of
the SIGTERM is fixed by the worker's wait, not by how many updates fit in
a sleep, so a run is deterministic in its steps.

``--smoke`` runs the same corpus, loss and orchestration with a 2-layer,
hidden-32 BERT at 96 px, on the CPU unless ``--device`` says otherwise.
On a card a CUDA matmul must round-trip in a fresh process first; if it
does not, the run aborts (it never carries on on the CPU).

Prints one JSON line (a failure or the deadline prints ``value: null``,
utils/tool_run.py); exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_FRM = 2
BATCH_VIDEOS = 8
CAPS_PER_VIDEO = 4
N_VIDEOS = 8
SAVE_RATIO = 0.26
HOLD_PAST_BUNDLE = 2         # updates past the first bundle at the SIGTERM
WORKER_WAIT_S = 900          # the held worker's wait for its SIGTERM
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALETTE = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
           (255, 0, 255), (0, 255, 255), (255, 255, 255), (30, 30, 30)]
COLOR_WORDS = ["red", "green", "blue", "yellow", "magenta", "cyan",
               "white", "black"]
TINY_MODEL = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, max_position_embeddings=64,
    max_grid_row_position_embeddings=8, max_grid_col_position_embeddings=8)


def build_corpus(root: str) -> None:
    """The vocabulary, 8 strongly distinguishable 320x240 videos (a stripe
    pattern per index) and 4 captions each, into ``root``."""
    from clipbert_tpu_torch.data import store, tokenization, video
    tokenization.write_tiny_vocab(
        os.path.join(root, "vocab.txt"),
        extra_tokens=["a", "person", "does", "thing", "very"]
        + COLOR_WORDS + [str(i) for i in range(100)])
    with store.PackWriter(os.path.join(root, "videos.cbpk")) as w:
        for i in range(N_VIDEOS):
            frames = np.zeros((24, 240, 320, 3), np.uint8)
            frames[:] = PALETTE[i]
            frames[:, :: (i + 2), :, :] //= 2
            w.put(f"vid{i}", video.encode_jseq_from_array(frames, fps=8))
    with open(os.path.join(root, "pretrain.jsonl"), "w") as f:
        for i in range(N_VIDEOS):
            for c in range(CAPS_PER_VIDEO):
                txt = (f"a person does thing {i} very "
                       + " ".join([COLOR_WORDS[i]] * 6) + f" {c}")
                f.write(json.dumps({"vid_id": f"vid{i}", "txt": txt}) + "\n")


def first_bundle_step(steps: int) -> int:
    """The trainer's save interval for a run of ``steps`` updates."""
    return max(1, int(SAVE_RATIO * steps))


def run_config(root: str, out_dir: str, steps: int, smoke: bool,
               device: str, img: int):
    from clipbert_tpu_torch.core.config import DatasetSpec, RunConfig
    # mk_input_group splits each video's captions into groups of 2
    groups_total = N_VIDEOS * CAPS_PER_VIDEO // 2
    steps_per_epoch = max(1, groups_total // BATCH_VIDEOS)
    model_cfg = os.path.join(ROOT, "configs", "base_model.json")
    if smoke:
        from clipbert_tpu_torch.data.tokenization import BertTokenizer
        model_cfg = os.path.join(root, "tiny_model.json")
        with open(model_cfg, "w") as f:
            json.dump(dict(TINY_MODEL, vocab_size=len(BertTokenizer(
                os.path.join(root, "vocab.txt")))), f)
    lr = 5e-3 if smoke else 1e-3
    return RunConfig(
        model_config=model_cfg, tokenizer_dir=root, output_dir=out_dir,
        bf16=not smoke, max_img_size=img, max_txt_len=20,
        train_batch_size=BATCH_VIDEOS, num_frm=NUM_FRM, fps=2,
        use_mlm=True, use_itm=True, itm_neg_prob=0.5,
        max_n_example_per_group=2, pixel_random_sampling_size=0,
        num_train_epochs=steps / steps_per_epoch,
        learning_rate=lr, cnn_learning_rate=lr,
        decay="constant", cnn_lr_decay="constant",
        # a history entry every ~steps/10; a restore bundle every ~steps/4
        num_valid=10, min_valid_steps=1, save_steps_ratio=SAVE_RATIO,
        n_workers=1, seed=11, device=device,
        train_datasets=[DatasetSpec(
            name="pre", txt=os.path.join(root, "pretrain.jsonl"),
            img=os.path.join(root, "videos.cbpk"), vis_format="video")],
        val_datasets=[])


def state_digest(state) -> str:
    """sha256 of a train state's weights and buffers, moments and update
    count: what a restore bundle holds."""
    import torch

    from clipbert_tpu_torch.ckpt.from_jax import model_state
    h = hashlib.sha256(str(state.opt.step).encode())
    for tree in (model_state(state.model), state.opt.mu, state.opt.nu):
        for n in sorted(tree):
            h.update(n.encode())
            h.update(tree[n].detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def worker(args) -> None:
    """One training process: its per-step losses (from the trainer's
    train scalars), the step it resumed at, the digests of the state it
    saved at the held update and of the state it loaded, and where it
    ended, into ``args.result``. With ``--hold_at N`` it writes ``args.hold_marker``
    after update N and waits until the orchestrator removes it (its
    SIGTERM comes first), so the trainer stops at step N."""
    import torch

    from clipbert_tpu_torch.ckpt import checkpoint as ck
    from clipbert_tpu_torch.tasks import run_pretrain
    from clipbert_tpu_torch.train import steps as steps_mod
    from clipbert_tpu_torch.train import trainer
    from clipbert_tpu_torch.utils import logger

    if args.threads:
        torch.set_num_threads(args.threads)
    resumed = {"step": None}
    restore = ck.TrainingRestorer.restore

    def restore_noting(self, *a, **k):
        out = restore(self, *a, **k)
        if out is not None:
            resumed["step"] = int(out[0])
        return out

    ck.TrainingRestorer.restore = restore_noting
    digests = {"saved": None, "restored": None}
    bundle_of, load = trainer.restore_bundle, trainer.load_bundle

    def bundle_noting(state):
        if args.hold_at and state.opt.step >= args.hold_at:
            digests["saved"] = state_digest(state)     # the SIGTERM's bundle
        return bundle_of(state)

    def load_noting(state, tree):
        load(state, tree)
        digests["restored"] = state_digest(state)

    trainer.restore_bundle, trainer.load_bundle = bundle_noting, load_noting
    step_losses = []
    log = logger.TB_LOGGER.log_scalar_dict

    def capture(log_dict, prefix=""):
        if prefix == "train" and "train_loss" in log_dict:
            step_losses.append(float(log_dict["train_loss"]))
        return log(log_dict, prefix)

    logger.TB_LOGGER.log_scalar_dict = capture
    # the scalars go to JSON lines: the tensorboard writer's imports take
    # longer than a smoke run's updates
    logger.TB_LOGGER.create = lambda path: setattr(
        logger.TB_LOGGER, "_writer", logger.JsonlScalarWriter(path))
    if args.hold_at:
        make = steps_mod.make_train_step

        def holding(*a, **k):
            step = make(*a, **k)
            calls = [0]

            def run(state, batch, seed):
                out = step(state, batch, seed)
                calls[0] += 1
                if calls[0] == args.hold_at:
                    float(out[1]["loss"])          # the update is done
                    with open(args.hold_marker, "w") as f:
                        f.write(str(calls[0]))
                    stop_at = time.monotonic() + WORKER_WAIT_S
                    while os.path.exists(args.hold_marker):
                        if time.monotonic() > stop_at:
                            raise RuntimeError("no SIGTERM came")
                        time.sleep(0.05)
                return out
            return run

        steps_mod.make_train_step = holding
    cfg = run_config(args.root, args.out, args.steps, args.smoke,
                     args.device, args.img)
    result = run_pretrain.start_training(cfg)
    with open(args.result, "w") as f:
        json.dump({"global_step": result["global_step"],
                   "resumed_step": resumed["step"],
                   "saved_digest": digests["saved"],
                   "restored_digest": digests["restored"],
                   "history": [{"step": h["step"], "loss": h["loss"]}
                               for h in result["history"]],
                   "step_losses": step_losses}, f)
    print("WORKER_DONE", result["global_step"], flush=True)


_PROBE = ("import torch\n"
          "x = torch.ones(1024, 1024, dtype=torch.bfloat16, device='cuda')\n"
          "print(float((x @ x).float()[0, 0]))\n")


def health_probe(timeout_s: float = 120.0) -> float:
    """A bf16 matmul on the card must round-trip in a fresh process."""
    try:
        done = subprocess.run([sys.executable, "-c", _PROBE],
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise RuntimeError("health probe timed out: the card is wedged; "
                           "aborting")
    if done.returncode != 0:
        raise RuntimeError(f"health probe exited {done.returncode}: "
                           f"{done.stderr[-1000:]}; aborting")
    val = float(done.stdout.strip().splitlines()[-1])
    if val != 1024.0:
        raise RuntimeError(f"health probe returned {val}, not 1024; aborting")
    return val


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny BERT at 96 px (on the CPU unless --device)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="cuda (cpu with --smoke)")
    ap.add_argument("--img", type=int, default=None,
                    help="frame size (448; 96 with --smoke)")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch threads a worker (0: torch's default)")
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="print value null and exit 124 after this many "
                         "seconds (0: no deadline)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    ap.add_argument("--hold_at", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--hold_marker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.device = args.device or ("cpu" if args.smoke else "cuda")
    args.img = args.img or (96 if args.smoke else 448)
    return args


def _wait(p: subprocess.Popen, cond, what: str, timeout_s: float) -> None:
    stop_at = time.monotonic() + timeout_s
    while not cond():
        if p.poll() is not None:
            raise RuntimeError(f"the worker exited {p.returncode} before "
                               f"{what}:\n{_tail(p)}")
        if time.monotonic() > stop_at:
            raise RuntimeError(f"no {what} within {timeout_s} s")
        time.sleep(0.1)


def _tail(p: subprocess.Popen) -> str:
    with open(p.log_path) as f:
        return f.read()[-4000:]


def orchestrate(args, run) -> dict:
    from clipbert_tpu_torch.utils.tool_run import card, device_of
    device = device_of(args.device)
    name = card(device)
    if device.type == "cuda":
        run.at("health probe")
        health_probe()
    hold = first_bundle_step(args.steps) + HOLD_PAST_BUNDLE
    if hold >= args.steps:
        raise ValueError(f"--steps {args.steps} is too short: the SIGTERM "
                         f"comes after update {hold}")
    procs = []

    def stop_all():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    run.on_exit(stop_all)
    with tempfile.TemporaryDirectory(prefix="conv_run_") as root:
        build_corpus(root)
        out_dir = os.path.join(root, "out")
        marker = os.path.join(root, "held")

        def launch(tag, hold_at=0):
            res = os.path.join(root, f"result_{tag}.json")
            log_path = os.path.join(root, f"worker_{tag}.log")
            cmd = [sys.executable, "-m", "clipbert_tpu_torch.train_convergence",
                   "--worker", "--steps", str(args.steps), "--root", root,
                   "--out", out_dir, "--result", res, "--device", args.device,
                   "--img", str(args.img), "--threads", str(args.threads),
                   "--hold_at", str(hold_at), "--hold_marker", marker] + (
                       ["--smoke"] if args.smoke else [])
            with open(log_path, "w") as log:
                p = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                                     stderr=subprocess.STDOUT)
            p.log_path = log_path
            procs.append(p)
            return p, res

        run.at(f"phase A: to update {hold}, then SIGTERM")
        t0 = time.perf_counter()
        pa, res_a = launch("a", hold)
        bundle = os.path.join(out_dir, "restore.npz")
        _wait(pa, lambda: os.path.exists(marker) and os.path.exists(bundle),
              "the held update and the first restore bundle", 3600)
        pa.send_signal(signal.SIGTERM)
        os.remove(marker)
        if pa.wait(timeout=900) != 0:
            raise RuntimeError(f"phase A exited {pa.returncode}:\n"
                               f"{_tail(pa)}")
        wall_a = time.perf_counter() - t0
        with open(res_a) as f:
            a = json.load(f)
        if a["resumed_step"] is not None or a["global_step"] != hold:
            raise RuntimeError(f"phase A: resumed {a['resumed_step']}, "
                               f"stopped at {a['global_step']}, not {hold}")
        run.at("phase B: resume to the end")
        t0 = time.perf_counter()
        pb, res_b = launch("b")
        if pb.wait(timeout=3600) != 0:
            raise RuntimeError(f"phase B exited {pb.returncode}:\n"
                               f"{_tail(pb)}")
        wall_b = time.perf_counter() - t0
        with open(res_b) as f:
            b = json.load(f)
    first = a["step_losses"][0]

    def tail(xs):
        return sum(xs[-5:]) / len(xs[-5:])

    at_sigterm = tail(a["step_losses"])
    last = tail(b["step_losses"]) if b["step_losses"] else float("nan")
    resumed_first = b["step_losses"][0] if b["step_losses"] else None
    floor = math.log(2.0)
    restored = (b["restored_digest"] is not None
                and b["restored_digest"] == a["saved_digest"])
    verdicts = {
        "resumed_at_sigterm": (b["resumed_step"] == a["global_step"]
                               and b["global_step"] == args.steps),
        "descends": (last - floor) < 0.6 * (first - floor),
        "resume_continues": (restored and resumed_first is not None
                             and resumed_first <= 1.25 * at_sigterm + 0.05),
    }
    return {
        "metric": ("cpu_smoke_convergence_run" if args.smoke
                   else "convergence_run"),
        "value": last, "unit": "smoothed final loss",
        "steps": args.steps, "img": args.img,
        "sigterm_at_step": a["global_step"],
        "resumed_step": b["resumed_step"], "global_step": b["global_step"],
        "first_loss": first, "loss_at_sigterm": at_sigterm,
        "first_resumed_loss": resumed_first, "final_loss": last,
        "restored_state_matches": restored,
        "itm_floor": floor, "step_losses_a": a["step_losses"],
        "step_losses_b": b["step_losses"],
        "wall_a_s": wall_a, "wall_b_s": wall_b, "card": name, **verdicts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return {}
    from clipbert_tpu_torch.utils.tool_run import ToolRun
    with ToolRun("convergence_run", args.deadline_s) as run:
        out = orchestrate(args, run)
        run.emit(out)
    if not all(out[k] for k in ("resumed_at_sigterm", "descends",
                                "resume_continues")):
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
