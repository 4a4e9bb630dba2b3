"""Driver: text-to-video retrieval eval through the port's
``tasks/run_video_retrieval.py::inference_retrieval`` with Kimi-VL-A3B's
language model as ClipBERT's joint transformer (``joint_encoder``
"deepseek_v3": latent attention and 64 routed experts, top 6, at the
published widths, all 27 layers on one card).

Each call scores the traffic's captions against ``videos_per_call`` new
videos, as ``retrieval_eval`` does (its dataset helper is reused: decode
stubbed by a pool of seeded videos), on the production path: the device
resize, the CNN's kernels, the visual embedding, the decoder with the
fused attention's latent-attention body and the grouped expert GEMM, the
head and the clip pooling. The window is whole calls.

The check, stage by stage, on a sample drawn from the seed: the traffic's
``check_videos`` videos of the window's first call against the captions
of one of its caption dispatches (all 16 clips: at 2 videos and 16
captions, 512 sequences), whose every MoE layer's input, output and
chosen experts are kept where the timed dispatch computed them. The taps
hold those rows alone and, on the card, copy them on a side stream into
pinned host buffers reserved at set-up, so that the window's peak device
memory is the program's own:

- ``grid_rel_rms``: the CNN stage, the window's grid features against the
  float32 reference CNN (benchmark/reference/clipbert_ref.py) from the
  raw frames, as retrieval_eval checks it;
- ``route_mismatch``: per MoE layer, the float32 reference router
  (benchmark/reference/kimi_vl_lm_ref.py) on the program's own router
  input, the tokens whose chosen set differs from the program's where the
  reference's 6th-vs-7th biased-score margin exceeds the band ``delta``:
  the largest change two scores' difference can take when the same 2048
  products are summed in another float32 order, 0.5 * 2048 * 2^-24 *
  max_e sum_i |w_ei x_i| (the input is the program's bf16 one on both
  sides, so its rounding is shared); the limit is 0;
- ``moe_rel_rms``: per MoE layer, the reference's routed and shared
  experts in float32 on the program's input with the program's choice
  (so genuine near-ties are not counted here; the choice is checked
  above), the RMS gap of the layer's output over the reference's RMS, the
  largest over the layers;
- ``score_gap_centered_rms``: the joint stage, the window's scores as
  positive-class log-odds against the float32 reference run free from the
  program's grid features through the visual embedding, all 27 layers
  (each MoE layer given the program's choice), the final norm of the last
  text token, the head and the LSE clip pooling; the RMS gap less each
  video's mean gap.

The reference's language-model weights are the program's bf16 values,
redrawn by name (benchmark/kimi_weights.py) and widened to float32 one
layer at a time. The control (``ctx.mode`` "control") runs the same path
with every expert weight, routed and shared, rounded to float8 e4m3 under
a per-matrix scale; it must fail ``moe_rel_rms``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from benchmark import kimi_flops, kimi_weights, model_flops, weights
from benchmark.drivers import _common as C
from benchmark.drivers import retrieval_eval as base
from benchmark.reference import clipbert_ref as cref
from benchmark.reference import kimi_vl_lm_ref as ref

STREAM_SAMPLE = 5
FP8_MAX = 448.0


def _aux_config(cfg: Dict) -> Dict:
    """The ClipBERT parts (CNN, visual embedding, head) are drawn and
    imported as the msrvtt_ret cell's are: through a BERT configuration
    whose text side is one small layer, which is dropped."""
    return dict(cfg, joint_encoder="bert", num_hidden_layers=1,
                intermediate_size=64, vocab_size=8,
                max_position_embeddings=8, type_vocab_size=2,
                hidden_act="gelu")


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Each matrix rounded to float8 e4m3 under the scale that maps its
    largest magnitude to 448, back in t's dtype."""
    s = t.float().abs().amax(dim=(-2, -1), keepdim=True).clamp(
        min=1e-30) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


@torch.no_grad()
def _round_experts(lm) -> None:
    """The control: every expert matrix, routed (each expert's gate, up
    and down) and shared, rounded to float8 e4m3, in place."""
    from clipbert_tpu_torch.models import deepseek_v3
    for layer in lm.model.layers:
        if isinstance(layer.mlp, deepseek_v3.MoE):
            ex, sh = layer.mlp.experts, layer.mlp.shared_experts
            half = ex.gate_up_proj.shape[1] // 2
            for t in (ex.gate_up_proj[:, :half], ex.gate_up_proj[:, half:],
                      ex.down_proj, sh.gate_proj.weight, sh.up_proj.weight,
                      sh.down_proj.weight):
                t.copy_(_fp8_round(t))


def setup(ctx) -> base.State:
    # the parent commit has no expert layer: it stops here, at once
    from clipbert_tpu_torch.models import clipbert, deepseek_v3
    from clipbert_tpu_torch.tasks.run_video_retrieval import \
        inference_retrieval
    cfg, tr = ctx.config, ctx.traffic
    st = base.State()
    st.cfg, st.seed = cfg, ctx.seed
    st.n_clips, st.num_frm = cfg["inference_n_clips"], cfg["num_frm"]
    st.frame_hw = cfg["assumed"]["stub_frame_hw"]
    st.videos_per_call = cfg["assumed"]["inference_video_batch_size"]
    st.pool = [C.frames(ctx.seed, base.STREAM_VIDEO, i,
                        st.n_clips * st.num_frm, st.frame_hw)
               for i in range(tr["video_pool"])]
    st.tok = C.tokenizer(cfg["vocab_size"])
    st.captions = C.texts(C.rng(ctx.seed, base.STREAM_TEXT), tr["captions"],
                          tr["caption_words"], cfg["vocab_size"])
    st.caption_text = [C.as_string(c) for c in st.captions]
    n_out = cref.num_outputs(cfg, "retrieval")
    st.model_cfg, st.run_cfg = C.port_configs(
        cfg, n_out, inference_video_batch_size=st.videos_per_call,
        n_workers=tr["loader_threads"], device=ctx.device.type)
    st.dtype = torch.bfloat16 if cfg["bf16"] else torch.float32
    # the CNN, visual embedding and head, as retrieval_eval draws and
    # imports them; the reference keeps those tensors
    aux = _aux_config(cfg)
    w = weights.make_weights(aux, "retrieval", ctx.seed, ctx.device)
    aux_cfg, _ = C.port_configs(aux, n_out)
    parts = weights.load_into_port(w, aux_cfg, "retrieval",
                                   cfg["img_input_format"] == "BGR",
                                   ctx.device)
    keep = (cref.CNN, "cnn.grid_encoder", cref.BERT + "visual_embeddings.",
            "transformer.classifier.")
    st.w = {k: v for k, v in w.items() if k.startswith(keep)}
    del w
    lm_dtype = st.dtype if ctx.device.type == "cuda" else None
    model = clipbert.empty_clipbert(st.model_cfg, "retrieval",
                                    device=ctx.device, lm_dtype=lm_dtype)
    kimi_weights.load_into_port(model.transformer.language_model, cfg,
                                ctx.seed, ctx.device)
    model.cnn = parts.cnn
    model.transformer.visual_embeddings = \
        parts.transformer.bert.visual_embeddings
    model.transformer.classifier = parts.transformer.classifier
    del parts
    model.eval().requires_grad_(False)
    clipbert.fold_cnn_bn_scales(model)
    if ctx.mode == "control":
        _round_experts(model.transformer.language_model)
    st.model = model
    st.tap_bufs = _tap_buffers(cfg, tr, st.n_clips) \
        if ctx.device.type == "cuda" else None
    st.entry = inference_retrieval
    st.deepseek_v3 = deepseek_v3
    # every shape of the window: one video group's encode and one full
    # caption dispatch
    inference_retrieval(st.run_cfg, st.model_cfg, model,
                        base._dataset(st, 0, cfg["inference_batch_size"]),
                        st.dtype)
    return st


def _tap_buffers(cfg: Dict, tr: Dict, n_clips: int) -> Dict:
    """Pinned host buffers for the taps of every MoE layer at the longest
    sequence: {"x", "f": (layers, rows x D) bf16, "idx": (layers, rows x
    top_k) int64}, rows = check_videos x clips x captions a dispatch x
    tokens."""
    n_moe = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    rows = (tr["check_videos"] * n_clips * cfg["inference_batch_size"]
            * model_flops.joint_len(cfg))
    width = {"x": cfg["hidden_size"], "f": cfg["hidden_size"],
             "idx": cfg["num_experts_per_tok"]}
    dtype = {"x": torch.bfloat16, "f": torch.bfloat16, "idx": torch.int64}
    return {k: torch.empty(n_moe, rows * width[k], dtype=dtype[k],
                           pin_memory=True) for k in width}


class _Taps:
    """While on, the MoE layers of the window's ``target``-th decoder call
    (one caption dispatch) hand over their input, output and chosen
    experts for the sample's sequences: each sample video's block of
    ``per_video`` (clips x captions) sequences. With ``bufs``
    (:func:`_tap_buffers`) each is copied on a side stream into layer m's
    pinned buffer; without, cloned where it is."""

    def __init__(self, deepseek_v3, moe, target: int, videos: List[int],
                 per_video: int, bufs=None):
        self.ds, self.moe = deepseek_v3, moe
        self.target, self.videos, self.per = target, videos, per_video
        self.bufs = bufs
        self.side = torch.cuda.Stream() if bufs is not None else None
        self.calls = 0
        self.seq = 0
        self.x: List[torch.Tensor] = []
        self.f: List[torch.Tensor] = []
        self.idx: List[torch.Tensor] = []
        self._stack = contextlib.ExitStack()

    def _keep(self, kind: str, t: torch.Tensor, seq_len: int = 1) -> None:
        """Append the sample's rows of t to the list ``kind``."""
        n = self.per * seq_len
        rows = torch.cat([t[v * n:(v + 1) * n] for v in self.videos])
        kept = getattr(self, kind)
        if self.bufs is None:
            kept.append(rows)
            return
        dst = self.bufs[kind][len(kept), :rows.numel()].view(rows.shape)
        self.side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.side):
            dst.copy_(rows, non_blocking=True)
        rows.record_stream(self.side)
        kept.append(dst)

    def __enter__(self) -> "_Taps":
        dec, layer, route = self.ds.decoder, self.ds.moe_layer, self.moe.route

        def decoder(*a, **kw):
            try:
                return dec(*a, **kw)
            finally:
                self.calls += 1

        def moe_layer(x, p, cfg):
            self.seq = x.shape[1]
            out = layer(x, p, cfg)
            if self.calls == self.target:
                self._keep("x", x)
                self._keep("f", out)
            return out

        def route_(x, *a, **kw):
            idx, w = route(x, *a, **kw)
            if self.calls == self.target:
                self._keep("idx", idx, self.seq)
            return idx, w

        for mod, name, fn in ((self.ds, "decoder", decoder),
                              (self.ds, "moe_layer", moe_layer),
                              (self.moe, "route", route_)):
            self._stack.enter_context(_patched(mod, name, fn))
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.close()
        if self.side is not None:
            self.side.synchronize()
        return False


@contextlib.contextmanager
def _patched(mod, name, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def window(st: base.State, ctx) -> Dict:
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.ops import moe
    from clipbert_tpu_torch.utils import profiling
    n_caps = len(st.captions)
    vpc, bsz = st.videos_per_call, st.cfg["inference_batch_size"]
    g = C.rng(ctx.seed, STREAM_SAMPLE)
    st.sample_videos = sorted(int(v) for v in g.choice(
        vpc, ctx.traffic["check_videos"], replace=False))
    st.sample_batch = int(g.integers(0, -(-n_caps // bsz)))
    st.scores, st.grids = [], []
    waits = walls = 0.0
    taps = _Taps(st.deepseek_v3, moe, st.sample_batch, st.sample_videos,
                 st.n_clips * bsz, st.tap_bufs)

    def keep_grids(g):
        # the first call's encode: the sample videos' grid features
        if not st.grids:
            st.grids.append(g.reshape((vpc, st.n_clips) + g.shape[1:])[
                st.sample_videos].clone())

    moe.reset_expert_load()
    with C.tapped(clipbert, "cnn_forward", keep_grids), taps, \
            profiling.collect():
        t0 = time.perf_counter()
        while True:
            k = len(st.scores)
            stats: Dict = {}
            ds = base._dataset(st, k * vpc, n_caps)
            tc = time.perf_counter()
            out = st.entry(st.run_cfg, st.model_cfg, st.model, ds,
                           st.dtype, stats)
            walls += time.perf_counter() - tc
            waits += stats["data_wait_s"]
            st.scores.append(out["score_matrix"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elapsed = time.perf_counter() - t0
    st.taps = taps
    load = moe.expert_load()
    load_stats = {}
    if load is not None:
        load = load.double()
        load_stats = {"expert_rows_max_over_mean":
                      float(load.max() / load.mean()),
                      "expert_rows_min_over_mean":
                      float(load.min() / load.mean())}
        ctx.log(f"rows per expert over the window: {load_stats}")
    calls = len(st.scores)
    pairs = calls * vpc * n_caps
    cfg = st.cfg
    seq = model_flops.joint_len(cfg)
    size = cfg["max_img_size"]
    flops = (calls * vpc * st.n_clips * st.num_frm
             * model_flops.cnn_flops(size, size, cfg["hidden_size"],
                                     cfg["backbone_channel_in_size"])
             + pairs * st.n_clips * kimi_flops.deepseek_seq_flops(
                 cfg, seq, cref.num_outputs(cfg, "retrieval")))
    return {"e2e": {"eval_pairs_per_s": pairs / elapsed},
            "work": {"model_flops": flops, "pairs": pairs, "calls": calls},
            "stats": {"data_wait_s": waits, "calls_wall_s": walls,
                      **load_stats},
            "attempted": pairs, "failed": 0}


def release(st: base.State) -> None:
    del st.model, st.entry


def _route_check(W, pre: str, cfg: Dict, x: torch.Tensor,
                 prog_idx: torch.Tensor) -> int:
    """Tokens whose chosen set differs from the reference router's on the
    same input, where the reference's 6th-vs-7th margin exceeds the
    float32 summation band."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores, biased = ref.router_scores(W, pre, x)
    top = torch.topk(biased, k + 1, dim=-1).values
    margin = top[:, k - 1] - top[:, k]
    gw = W[pre + "gate.weight"]
    band = 0.5 * x.shape[1] * 2.0 ** -24 * (x.abs() @ gw.abs().t()).amax(-1)
    want = torch.zeros(x.shape[0], E, dtype=torch.bool, device=x.device)
    got = torch.zeros_like(want)
    want.scatter_(1, ref.select(biased, k), True)
    got.scatter_(1, prog_idx, True)
    differ = (want != got).any(dim=-1)
    return int((differ & (margin > band)).sum())


@torch.no_grad()
def check(st: base.State, ctx) -> Dict[str, float]:
    cfg, tr = st.cfg, ctx.traffic
    ref.strict_fp32()
    cref.strict_fp32()
    device = ctx.device
    nc, bsz = st.n_clips, cfg["inference_batch_size"]
    D = cfg["hidden_size"]
    caps = list(range(st.sample_batch * bsz,
                      min(len(st.captions), (st.sample_batch + 1) * bsz)))
    ids, mask = C.as_ids([st.captions[i] for i in caps], cfg["max_txt_len"])
    ids = torch.from_numpy(ids).to(device)
    mask = torch.from_numpy(mask).to(device)
    grids = st.grids[0].to(device).float()       # (videos, nc, T, h, w, D)
    # the CNN stage
    cnn = C.Gaps()
    for j, v in enumerate(st.sample_videos):
        frames = torch.from_numpy(st.pool[v % len(st.pool)]).to(device)
        cnn.add(grids[j], cref.video_grids(st.w, cfg, frames, nc))
    # the reference's names for ClipBERT's parts
    W0 = {"model.embed_tokens.weight": None}
    for leaf in ("row_position_embeddings.weight",
                 "col_position_embeddings.weight",
                 "token_type_embeddings.weight", "LayerNorm.weight",
                 "LayerNorm.bias"):
        W0["visual_embeddings." + leaf] = \
            st.w[cref.BERT + "visual_embeddings." + leaf]
    for i, fc in ((0, "fc1"), (2, "fc2")):
        for leaf in ("weight", "bias"):
            W0[f"classifier.{fc}.{leaf}"] = \
                st.w[f"transformer.classifier.{i}.{leaf}"]
    emb = kimi_weights.tensor(cfg, st.seed, "model.embed_tokens.weight",
                              (cfg["vocab_size"], D), device)
    # the sample captions' rows of the embedding, which txt_ids index
    W0["model.embed_tokens.weight"] = emb[ids].float().reshape(-1, D)
    del emb
    txt_ids = torch.arange(ids.numel(), device=device).reshape(ids.shape)
    # the sample in dispatch order: (video, clip, caption)
    n = len(st.sample_videos) * nc
    B = n * len(caps)
    rows = torch.arange(len(caps), device=device).repeat(n)
    grid_seq = grids.reshape((n,) + grids.shape[2:]).repeat_interleave(
        len(caps), dim=0)
    h, key_bias, last = ref.joint_input(W0, cfg, grid_seq, txt_ids[rows],
                                        mask[rows])
    del grid_seq
    taps = st.taps
    S = h.shape[1]
    route_bad = 0
    moe_gaps = []
    k_dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        Wl = kimi_weights.layer(cfg, st.seed, i, device)
        given = None
        if i >= k_dense:
            m = i - k_dense
            pre = f"model.layers.{i}.mlp."
            x = taps.x[m].to(device).float().reshape(-1, D)
            given = taps.idx[m].to(device)
            route_bad += _route_check(Wl, pre, cfg, x, given)
            f_ref, _ = ref.moe(Wl, pre, cfg, x, given)
            gap = C.Gaps()
            gap.add(taps.f[m].to(device).float().reshape(-1, D), f_ref)
            moe_gaps.append(gap.rel_rms())
            del x, f_ref
        h, _ = ref.layer(Wl, i, cfg, h, key_bias, given)
        del Wl
    Wn = {"model.norm.weight": kimi_weights.tensor(
        cfg, st.seed, "model.norm.weight", (D,), device).float(), **W0}
    logits = ref.head(Wn, ref.pooled(Wn, cfg, h, last))
    pooled = torch.logsumexp(logits.reshape(len(st.sample_videos), nc,
                                            len(caps), -1), dim=1)
    want = (pooled[..., 1] - pooled[..., 0]).cpu()
    centered = C.Gaps()
    for j, v in enumerate(st.sample_videos):
        p = torch.from_numpy(st.scores[0][v, caps]).double()
        got = torch.log(p) - torch.log1p(-p)
        shift = float((got - want[j].double()).mean())
        centered.add(got - shift, want[j])
    ctx.log(f"CNN stage over {len(st.sample_videos)} videos: {cnn.stats()}; "
            f"MoE layers' relative RMS gaps: "
            f"{[round(g, 6) for g in moe_gaps]}; route mismatches outside "
            f"the band: {route_bad}; joint stage over {B // nc} pairs, each "
            f"video's mean gap removed: {centered.stats()}")
    return {"grid_rel_rms": cnn.rel_rms(),
            "route_mismatch": float(route_bad),
            "moe_rel_rms": max(moe_gaps) if moe_gaps else float("nan"),
            "score_gap_centered_rms": centered.rms()}
