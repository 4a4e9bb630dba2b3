"""Driver: VQA evaluation through the port's ``tasks/run_vqa.py::
build_validate`` loop with ``train/steps.py::make_eval_step``.

Each call of the validation runs ``questions_per_call`` questions, one an
image, in batches of the configuration's ``val_batch_size``, through the
port's threaded loader with ``loader_workers`` threads, the
device resize, the CNN's kernels at the configured size, BERT with the
fused attention and the MLP head over every answer. Decode is stubbed by a
pool of seeded images of the configuration's native size. The window is
whole calls; ``vqa_pairs_per_s`` is every question answered over all of
its time.

The check, stage by stage, on batches drawn from the seed among those
the window produced: the CNN stage, the grid features the eval step's
CNN returned against the float32 reference CNN from the raw image (their
relative RMS gap); the joint stage, the logits the eval step returned
against the float32 reference's visual embedding, BERT and MLP head run
on those same grid features and the question ids (their RMS gap over
every answer). The port's int8 scoring path, the control of the joint
stage, leaves the CNN in bf16; the CNN stage's control is the reference
CNN in float8 (PERF.md)."""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import model_flops, weights
from benchmark.drivers import _common as C
from benchmark.reference import clipbert_ref as ref

STREAM_IMAGE, STREAM_TEXT, STREAM_CHECK = 1, 2, 3


class State:
    pass


def _questions(st, call: int, n: int):
    return C.texts(C.rng(st.seed, STREAM_TEXT, call), n,
                   st.traffic["question_words"], st.cfg["vocab_size"])


def _call(st, call: int, n: int, eval_fn) -> None:
    """One validation over questions call * n ... of call ``call``."""
    from clipbert_tpu_torch.data.datasets import RetrievalCollator, VQADataset
    from clipbert_tpu_torch.tasks import common, run_vqa
    pool = st.pool

    class StubDecode(VQADataset):
        def load_image(self, img_id):
            return pool[int(img_id[3:]) % len(pool)][None]

    qs = _questions(st, call, n)
    groups = [(f"img{call * n + j}",
               [{"txt": C.as_string(q), "question_id": call * n + j,
                 "labels": {"a0": 1.0}, "answer_type": "other"}])
              for j, q in enumerate(qs)]
    cfg = st.cfg
    ds = StubDecode(groups, st.tok, None, ans2label=st.ans2label,
                    max_img_size=cfg["max_img_size"],
                    max_txt_len=cfg["max_txt_len"], device_preprocess=True)
    loader = common.build_eval_loader(
        ds, RetrievalCollator(st.tok, cfg["max_txt_len"]), st.run_cfg)
    run_vqa.build_validate(st.run_cfg, ds, loader, st.dtype)(
        st.model, eval_fn)


def setup(ctx) -> State:
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.tasks import run_vqa
    from clipbert_tpu_torch.train import steps
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.cfg, st.traffic, st.seed = cfg, tr, ctx.seed
    hw = cfg["assumed"]["stub_image_hw"]
    st.pool = [C.frames(ctx.seed, STREAM_IMAGE, i, 1, hw)[0]
               for i in range(tr["image_pool"])]
    st.tok = C.tokenizer(cfg["vocab_size"])
    n_labels = cfg["num_labels"]
    st.ans2label = {f"a{i}": i for i in range(n_labels)}
    st.model_cfg, st.run_cfg = C.port_configs(
        cfg, n_labels, n_workers=tr["loader_workers"],
        device=ctx.device.type)
    B = st.run_cfg.val_batch_size
    if tr["questions_per_call"] % B:
        raise ValueError("questions_per_call must hold whole batches")
    w = weights.make_weights(cfg, "seq_cls", ctx.seed, ctx.device)
    model = weights.load_into_port(w, st.model_cfg, "seq_cls",
                                   cfg["img_input_format"] == "BGR",
                                   ctx.device)
    del w
    model.eval().requires_grad_(False)
    clipbert.fold_cnn_bn_scales(model)
    if ctx.mode == "control":
        clipbert.quantize_scoring_params(model)
    st.model = model
    st.dtype = torch.bfloat16 if cfg["bf16"] else torch.float32
    st.eval_step = steps.make_eval_step(
        st.model_cfg, run_vqa.make_task_settings(st.run_cfg, is_train=False),
        st.dtype)
    # the window's one batch shape
    _call(st, -1, 2 * st.run_cfg.val_batch_size, st.eval_step)
    return st


def window(st: State, ctx) -> Dict:
    n = st.traffic["questions_per_call"]
    B = st.run_cfg.val_batch_size
    keep_every = st.traffic["keep_every"]
    from clipbert_tpu_torch.models import clipbert
    kept: Dict[int, tuple] = {}
    counter = [0]
    last_grid = []

    def eval_fn(model, batch):
        out = st.eval_step(model, batch)
        if counter[0] % keep_every == st.seed % keep_every:
            kept[counter[0]] = (last_grid[-1], out["logits"])
        last_grid.clear()
        counter[0] += 1
        return out

    calls = 0
    walls = []
    # each batch's grid features, as the eval step's CNN returns them
    with C.tapped(clipbert, "cnn_forward", last_grid.append):
        t0 = time.perf_counter()
        while True:
            tc = time.perf_counter()
            _call(st, calls, n, eval_fn)
            walls.append(time.perf_counter() - tc)
            calls += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
    ctx.log("calls " + " ".join(f"{w:.3f}" for w in walls) + " s")
    st.kept = {k: (g.cpu(), v.float().cpu()) for k, (g, v) in kept.items()}
    st.per_call, st.batch = n, B
    pairs = calls * n
    cfg = st.cfg
    size = cfg["max_img_size"]
    flops = pairs * (
        model_flops.cnn_flops(size, size, cfg["hidden_size"],
                              cfg["backbone_channel_in_size"])
        + model_flops.bert_seq_flops(cfg, model_flops.joint_len(cfg),
                                     cfg["num_labels"]))
    return {"e2e": {"vqa_pairs_per_s": pairs / elapsed},
            "work": {"model_flops": flops, "pairs": pairs, "calls": calls},
            "stats": {}, "attempted": pairs, "failed": 0}


def release(st: State) -> None:
    del st.model, st.eval_step


@torch.no_grad()
def check(st: State, ctx) -> Dict[str, float]:
    cfg, tr = st.cfg, ctx.traffic
    ref.strict_fp32()
    device = ctx.device
    g = C.rng(ctx.seed, STREAM_CHECK)
    kept = sorted(st.kept)
    picked = g.choice(len(kept), min(tr["check_batches"], len(kept)),
                      replace=False)
    w = weights.make_weights(cfg, "seq_cls", ctx.seed, device)
    size = cfg["max_img_size"]
    bgr = cfg["img_input_format"] == "BGR"
    prec = ref.Precision("fp8" if ctx.mode == "control" else "fp32")
    want_grids: Dict[int, torch.Tensor] = {}
    cnn, joint = C.Gaps(), C.Gaps()
    for idx in sorted(kept[i] for i in picked):
        grid, logits = st.kept[idx]
        call, first = divmod(idx * st.batch, st.per_call)
        qs = _questions(st, call, st.per_call)[first:first + st.batch]
        ids, mask = C.as_ids(qs, cfg["max_txt_len"])
        vis = []
        for j in range(len(qs)):
            p = (call * st.per_call + first + j) % len(st.pool)
            px = ref.preprocess(torch.from_numpy(st.pool[p][None]).to(
                device), size, cfg["img_pixel_mean"], cfg["img_pixel_std"])
            if p not in want_grids:
                want_grids[p] = ref.cnn_forward(w, px, bgr)
            # the CNN stage: the port's grid features; the control's are
            # the reference CNN's in float8
            got = ref.cnn_forward(w, px, bgr, prec) \
                if ctx.mode == "control" else grid[j].to(device).float()
            cnn.add(got.reshape(want_grids[p].shape), want_grids[p])
            # the joint stage from the port's own grid features
            vis.append(ref.visual_tokens(
                w, cfg, grid[j:j + 1].to(device).float()))
        want = ref.joint_logits(w, cfg, torch.from_numpy(ids).to(device),
                                torch.from_numpy(mask).to(device),
                                torch.cat(vis))
        joint.add(logits, want.cpu())
    ctx.log(f"CNN stage: {cnn.stats()}; joint stage over {len(picked)} "
            f"batches: {joint.stats()}")
    return {"grid_rel_rms": cnn.rel_rms(), "logit_gap_rms": joint.rms()}
