"""Driver: full-matrix text-to-video retrieval eval through the port's
``tasks/run_video_retrieval.py::inference_retrieval``.

Each call of the entry scores the traffic's captions (the MSRVTT 1k-A
test's 1000) against ``videos_per_call`` new videos (one video group of
the loader), caption encoding and the retrieval metrics included. Decode
is stubbed by a pool of ``video_pool`` seeded videos at the
configuration's native size, made at set-up; the
device resize, the CNN's kernels, BERT with the fused attention, the
head and the clip pooling are the production path. The window is whole
calls; ``eval_pairs_per_s`` is every (caption, video) pair scored over
all of its time.

The check, stage by stage, on a sample of the window's videos drawn from
the seed against a sample of the captions with the longest among them:
the CNN stage, the grid features the window's encode produced against
the float32 reference CNN from the raw frames (their relative RMS gap);
the joint stage, the scores the window produced against the float32
reference's BERT, visual embedding, head and clip pooling run on those
same grid features, as the positive class's log-odds (the probability
the eval reports, as l1 - l0 of the LSE-pooled logits; their RMS gap
less each video's mean gap, which the ranking of a video's captions
does not see).
The port's int8 scoring path, the control of the joint stage, leaves the
CNN in bf16; the CNN stage's control is the reference CNN in float8
(PERF.md)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import model_flops, weights
from benchmark.drivers import _common as C
from benchmark.reference import clipbert_ref as ref

STREAM_VIDEO, STREAM_TEXT, STREAM_CHECK = 1, 3, 4


class State:
    pass


def _dataset(st, vid_base: int, n_caps: int):
    """The production eval dataset over captions 0..n_caps-1 and the
    videos vid_base .. vid_base + videos_per_call - 1, decode stubbed by
    the pool of seeded videos made at set-up (video v is pool[v % size]),
    so the loader threads do the collate and the copy, not the draw."""
    from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
    pool = st.pool

    class StubDecode(VideoRetrievalEvalDataset):
        def load_video_multi_clips(self, vid_id, n_clips, random_clips,
                                   prev_clip_fallback=False, rng=None):
            return pool[int(vid_id[1:]) % len(pool)]

    vpc = st.videos_per_call
    rows = [{"id": i, "txt": st.caption_text[i],
             "vid_id": f"v{vid_base + i % vpc}"} for i in range(n_caps)]
    return StubDecode(rows, st.tok, media_store=None, fps=1,
                      num_frm=st.num_frm, max_img_size=st.cfg["max_img_size"],
                      max_txt_len=st.cfg["max_txt_len"],
                      ensemble_n_clips=st.n_clips, device_preprocess=True)


def setup(ctx) -> State:
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.tasks.run_video_retrieval import \
        inference_retrieval
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.cfg, st.seed = cfg, ctx.seed
    st.n_clips, st.num_frm = cfg["inference_n_clips"], cfg["num_frm"]
    st.frame_hw = cfg["assumed"]["stub_frame_hw"]
    st.videos_per_call = cfg["assumed"]["inference_video_batch_size"]
    st.pool = [C.frames(ctx.seed, STREAM_VIDEO, i, st.n_clips * st.num_frm,
                        st.frame_hw) for i in range(tr["video_pool"])]
    st.tok = C.tokenizer(cfg["vocab_size"])
    st.captions = C.texts(C.rng(ctx.seed, STREAM_TEXT), tr["captions"],
                          tr["caption_words"], cfg["vocab_size"])
    st.caption_text = [C.as_string(c) for c in st.captions]
    n_out = ref.num_outputs(cfg, "retrieval")
    st.model_cfg, st.run_cfg = C.port_configs(
        cfg, n_out, inference_video_batch_size=st.videos_per_call,
        n_workers=tr["loader_threads"], device=ctx.device.type)
    w = weights.make_weights(cfg, "retrieval", ctx.seed, ctx.device)
    model = weights.load_into_port(w, st.model_cfg, "retrieval",
                                   cfg["img_input_format"] == "BGR",
                                   ctx.device)
    del w
    model.eval().requires_grad_(False)
    clipbert.fold_cnn_bn_scales(model)
    if ctx.mode == "control":
        clipbert.quantize_scoring_params(model)
    st.model = model
    st.dtype = torch.bfloat16 if cfg["bf16"] else torch.float32
    st.entry = inference_retrieval
    # every shape of the window: one video group's encode and one full
    # caption dispatch
    inference_retrieval(st.run_cfg, st.model_cfg, model,
                        _dataset(st, 0, cfg["inference_batch_size"]),
                        st.dtype)
    return st


def window(st: State, ctx) -> Dict:
    n_caps = len(st.captions)
    vpc = st.videos_per_call
    from clipbert_tpu_torch.models import clipbert
    st.scores, st.grids = [], []
    waits = walls = 0.0
    # the grid features of each call's one video group, as its encode
    # returns them (the joint stage's check starts from them)
    with C.tapped(clipbert, "cnn_forward", st.grids.append):
        t0 = time.perf_counter()
        while True:
            k = len(st.scores)
            stats: Dict = {}
            ds = _dataset(st, k * vpc, n_caps)
            tc = time.perf_counter()
            out = st.entry(st.run_cfg, st.model_cfg, st.model, ds,
                           st.dtype, stats)
            walls += time.perf_counter() - tc
            waits += stats["data_wait_s"]
            st.scores.append(out["score_matrix"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
    calls = len(st.scores)
    pairs = calls * vpc * n_caps
    cfg = st.cfg
    seq = model_flops.joint_len(cfg)
    size = cfg["max_img_size"]
    flops = (calls * vpc * st.n_clips * st.num_frm
             * model_flops.cnn_flops(size, size, cfg["hidden_size"],
                                     cfg["backbone_channel_in_size"])
             + pairs * st.n_clips * model_flops.bert_seq_flops(
                 cfg, seq, ref.num_outputs(cfg, "retrieval")))
    return {"e2e": {"eval_pairs_per_s": pairs / elapsed},
            "work": {"model_flops": flops, "pairs": pairs, "calls": calls},
            "stats": {"data_wait_s": waits, "calls_wall_s": walls},
            "attempted": pairs, "failed": 0}


def release(st: State) -> None:
    del st.model, st.entry
    st.grids = [g.cpu() for g in st.grids]


@torch.no_grad()
def check(st: State, ctx) -> Dict[str, float]:
    cfg, tr = st.cfg, ctx.traffic
    ref.strict_fp32()
    device = ctx.device
    g = C.rng(ctx.seed, STREAM_CHECK)
    vpc, nc = st.videos_per_call, st.n_clips
    n_vid = len(st.scores) * vpc
    vids = g.choice(n_vid, min(tr["check_videos"], n_vid), replace=False)
    lens = np.array([len(c) for c in st.captions])
    caps = np.unique(np.concatenate([
        [int(np.argmax(lens))],
        g.choice(len(st.captions), tr["check_captions"] - 1,
                 replace=False)]))
    ids, mask = C.as_ids([st.captions[i] for i in caps], cfg["max_txt_len"])
    ids = torch.from_numpy(ids).to(device)
    mask = torch.from_numpy(mask).to(device)
    w = weights.make_weights(cfg, "retrieval", ctx.seed, device)
    prec = ref.Precision("fp8" if ctx.mode == "control" else "fp32")
    cnn, bert, centered = C.Gaps(), C.Gaps(), C.Gaps()
    for v in vids:
        k, j = divmod(int(v), vpc)
        frames = torch.from_numpy(st.pool[int(v) % len(st.pool)]).to(device)
        want_grid = ref.video_grids(w, cfg, frames, nc)
        grid = st.grids[k].to(device).float()
        grid = grid.reshape((vpc, nc) + grid.shape[1:])[j]
        # the CNN stage: the port's grid features; the control's are the
        # reference CNN's in float8
        got_grid = ref.video_grids(w, cfg, frames, nc, prec) \
            if ctx.mode == "control" else grid
        cnn.add(got_grid, want_grid)
        # the joint stage from the port's own grid features
        want = torch.cat([ref.retrieval_score_logit(ref.retrieval_pooled(
            w, cfg, grid, ids[s], mask[s]))
            for s in ref.chunks(len(caps), tr["check_caption_chunk"])]).cpu()
        p = torch.from_numpy(st.scores[k][j, caps]).double()
        got = torch.log(p) - torch.log1p(-p)
        bert.add(got, want)
        # less the video's mean gap: the offset that bf16 rounding of a
        # video's near-equal output logits shares across its captions
        shift = float((got - want.double()).mean())
        centered.add(got - shift, want)
    ctx.log(f"CNN stage over {len(vids)} videos: {cnn.stats()}; joint "
            f"stage over {len(vids) * len(caps)} pairs: {bert.stats()}, "
            f"each video's mean gap removed: {centered.stats()}")
    return {"grid_rel_rms": cnn.rel_rms(),
            "score_gap_centered_rms": centered.rms()}
