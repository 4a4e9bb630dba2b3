"""The port's span facility (clipbert_tpu_torch/utils/profiling.py: span,
collect, totals) and the loops that carry its spans, on the CPU: off it
records nothing and reads no clock; under torch.profiler every span is a
profiler event of its name whose times agree with the span's own; parents
and self time; the eval loader's worker threads; ``inference_retrieval``'s
``stage_stats`` built from its spans; and a VQA validation's stages."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from clipbert_tpu_torch.core.config import (ModelConfig, RunConfig,
                                            inject_task_attrs)
from clipbert_tpu_torch.data import tokenization
from clipbert_tpu_torch.data.datasets import (RetrievalCollator, VQADataset,
                                              VideoRetrievalEvalDataset)
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.tasks import common, run_vqa
from clipbert_tpu_torch.tasks import run_video_retrieval as rvr
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils import profiling

AGREE_NS = 100_000     # a span's times against its profiler event's
WORDS = ["a", "cat", "dog", "runs", "the", "red", "car", "man", "sings"]
MODEL_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8)


@pytest.fixture(autouse=True)
def _fresh_totals(monkeypatch):
    """Each test reads totals() from nothing, and uses two torch threads."""
    monkeypatch.setattr(profiling, "_TOTALS", {})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def closed(monkeypatch):
    """Every span closed during the test, with the thread that closed it."""
    got = []
    exit_ = profiling.Span.__exit__

    def spy(self, *exc):
        out = exit_(self, *exc)
        got.append((self, threading.get_ident()))
        return out

    monkeypatch.setattr(profiling.Span, "__exit__", spy)
    return got


def _profile():
    """A CPU profiler that records every thread (torch's own records only
    the thread that starts it)."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _assert_events_agree(prof, spans):
    """Each span is a profiler event of its name, its start and end within
    AGREE_NS of the event's."""
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert spans
    for s, _ in spans:
        assert s.name in events, s.name
        a, b = min(events[s.name], key=lambda ab: abs(ab[0] - s.start_ns))
        assert abs(a - s.start_ns) <= AGREE_NS, (s.name, a - s.start_ns)
        assert abs(b - s.end_ns) <= AGREE_NS, (s.name, b - s.end_ns)


def test_off_records_nothing(monkeypatch):
    """No profiler and no collect(): span() is one shared no-op that reads
    no clock, opens no record_function range and leaves totals() empty,
    here and through device_batch and HostFetch."""
    def forbidden(*a):
        raise AssertionError("a span that is off did work")

    monkeypatch.setattr(profiling, "_CLOCK", forbidden)
    monkeypatch.setattr(profiling, "_Range", forbidden)
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("a")
    assert off is profiling.span("b")
    with off as got:
        pass
    assert got is None
    dev, _ = common.device_batch({"x": np.ones(3, np.float32)}, "cpu")
    common.HostFetch(dev["x"]).numpy()
    assert profiling.totals() == {}


def test_collect_takes_every_thread_and_stays_out_of_totals(closed):
    """collect() takes the spans of every thread closed while it is open,
    none after; without a profiler they stay out of totals()."""
    with profiling.collect() as c:
        with profiling.span("main"):
            pass
        t = threading.Thread(target=lambda: profiling.span("other")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with profiling.span("after"):
        pass
    assert {k: v["n"] for k, v in c.totals().items()} == \
        {"main": 1, "other": 1}
    threads = {s.name: t for s, t in closed}
    assert threads["main"] == threading.get_ident() != threads["other"]
    assert profiling.totals() == {}


@pytest.mark.parametrize("where", ["main", "thread"])
def test_span_is_a_profiler_event(where, closed):
    """Under torch.profiler each span is a record_function event of its
    name; the span's in-memory start and end agree with the event's within
    100 us, on the main thread and on another one."""
    def work():
        for i in range(3):
            with profiling.span(f"outer{i}"):
                with profiling.span("inner"):
                    torch.ones(256).sum()
                time.sleep(0.001)

    with _profile() as prof, profiling.collect() as c:
        if where == "main":
            work()
        else:
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert len(closed) == 6
    _assert_events_agree(prof, closed)
    assert profiling.totals()["inner"]["n"] == 3
    assert c.totals() == profiling.totals()


@pytest.mark.parametrize("how", ["collect", "profiler"])
def test_parents_and_self_time(how, closed):
    """A span's parent is the span open around it on its thread; self_s is
    its seconds less its children's, in collect()'s and totals()'
    aggregates alike."""
    with (_profile() if how == "profiler" else profiling.collect()) as scope:
        with profiling.span("outer"):
            with profiling.span("mid"):
                with profiling.span("leaf"):
                    time.sleep(0.002)
            with profiling.span("mid"):
                time.sleep(0.001)
            time.sleep(0.001)
    agg = scope.totals() if how == "collect" else profiling.totals()
    assert {k: v["n"] for k, v in agg.items()} == \
        {"outer": 1, "mid": 2, "leaf": 1}
    assert agg["leaf"]["self_s"] == pytest.approx(agg["leaf"]["s"])
    assert agg["mid"]["self_s"] == pytest.approx(
        agg["mid"]["s"] - agg["leaf"]["s"], abs=1e-9)
    assert agg["outer"]["self_s"] == pytest.approx(
        agg["outer"]["s"] - agg["mid"]["s"], abs=1e-9)
    assert agg["outer"]["self_s"] >= 0.001
    if how == "collect":
        by = {s.name: s for s, _ in closed}
        assert by["outer"].parent is None
        assert by["leaf"].parent.name == "mid"
        assert by["leaf"].parent.parent is by["outer"]


class _SlowItems:
    """Eight items that each take a millisecond to build."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(0.001)
        return np.full(4, i, np.float32)


@pytest.mark.parametrize("how", ["collect", "profiler"])
def test_eval_loader_spans_on_its_threads(how, closed):
    """build_eval_loader's two worker threads time each batch as a
    ``loader.batch`` span, collected under collect() and, with a profiler
    recording, summed into totals() and on the profiler's timeline."""
    cfg = RunConfig(model_config="", val_batch_size=2, n_workers=2)
    dl = common.build_eval_loader(_SlowItems(), np.stack, cfg)
    if how == "profiler":
        with _profile() as prof, profiling.collect() as c:
            got = list(dl)
        _assert_events_agree(prof, closed)
        assert profiling.totals()["loader.batch"]["n"] == 4
    else:
        with profiling.collect() as c:
            got = list(dl)
        assert profiling.totals() == {}
    assert len(got) == 4
    assert c.totals()["loader.batch"]["n"] == 4
    assert [s.name for s, _ in closed] == ["loader.batch"] * 4
    assert all(t != threading.get_ident() and s.ns >= 2e6
               for s, t in closed)


def test_concurrent_spans_lose_no_update():
    """Sixteen threads closing spans at once, the interpreter switching
    threads as often as it can: every span reaches collect() and
    totals()."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile(), profiling.collect() as c:
            ts = [threading.Thread(target=lambda: [
                profiling.span("x").__enter__().__exit__(None, None, None)
                for _ in range(200)]) for _ in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert c.totals()["x"]["n"] == 3200
    assert profiling.totals()["x"]["n"] == 3200


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans_tok")
    tokenization.write_tiny_vocab(str(d / "vocab.txt"), extra_tokens=WORDS)
    return tokenization.BertTokenizer.from_dir(str(d))


def _model(cfg, head):
    model = clipbert.init_clipbert(
        cfg, head, generator=torch.Generator().manual_seed(0), device="cpu")
    clipbert.fold_cnn_bn_scales(model)
    return model.eval().requires_grad_(False)


def test_stage_stats_from_spans(tok):
    """inference_retrieval's stage_stats come from its spans: the same
    keys, n_groups the dispatch spans, n_videos the videos scored, and the
    main thread's four stages within the call's wall."""
    rng = np.random.default_rng(5)
    pool = [rng.integers(0, 256, (4, 24, 32, 3), dtype=np.uint8)
            for _ in range(3)]

    class StubDecode(VideoRetrievalEvalDataset):
        def load_video_multi_clips(self, vid_id, n_clips, random_clips,
                                   prev_clip_fallback=False, rng=None):
            return pool[int(vid_id[1:])]

    rows = [{"id": i, "txt": " ".join(rng.choice(WORDS, 3)),
             "vid_id": f"v{i % 3}"} for i in range(5)]
    ds = StubDecode(rows, tok, media_store=None, fps=1, num_frm=2,
                    max_img_size=64, max_txt_len=8, ensemble_n_clips=2,
                    device_preprocess=True)
    run = RunConfig(model_config="", loss_type="ce", num_labels=2,
                    inference_n_clips=2, num_frm=2, max_img_size=64,
                    max_txt_len=8, inference_batch_size=4,
                    inference_video_batch_size=2, n_workers=2,
                    score_agg_func="lse", bf16=0)
    cfg = inject_task_attrs(ModelConfig(**MODEL_KW, vocab_size=len(tok)),
                            run)
    stats = {}
    t0 = time.perf_counter()
    out = rvr.inference_retrieval(run, cfg, _model(cfg, "retrieval"), ds,
                                  torch.float32, stats, use_kernels=False)
    wall = time.perf_counter() - t0
    assert out["score_matrix"].shape == (3, 5)
    assert set(stats) == {"setup_s", "data_wait_s", "dispatch_s", "fetch_s",
                          "n_groups", "decode_s", "put_s", "n_videos"}
    assert stats["n_groups"] == 2 and stats["n_videos"] == 3
    main = sum(stats[k] for k in ("data_wait_s", "dispatch_s", "fetch_s",
                                  "setup_s"))
    assert all(stats[k] > 0 for k in rvr.STAGE_SPANS)
    assert main <= wall
    assert profiling.totals() == {}


def test_vqa_validate_stages(tok, closed):
    """A float32 VQA validation on the CPU under the profiler yields every
    stage's span, on the profiler's timeline too; the main thread's data
    wait, copy and fetch wait are disjoint shares of the call."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (1, 40, 48, 3), dtype=np.uint8)
              for _ in range(3)]

    class StubDecode(VQADataset):
        def load_image(self, img_id):
            return images[int(img_id[3:]) % len(images)]

    groups = [(f"img{j}", [{"txt": " ".join(rng.choice(WORDS, 4)),
                            "question_id": j, "labels": {"a0": 1.0},
                            "answer_type": "other"}]) for j in range(6)]
    ans2label = {"a0": 0, "a1": 1, "a2": 2}
    ds = StubDecode(groups, tok, None, ans2label=ans2label, max_img_size=64,
                    max_txt_len=8, device_preprocess=True)
    run = RunConfig(model_config="", num_labels=3, max_img_size=64,
                    max_txt_len=8, val_batch_size=4, n_workers=2, bf16=0)
    cfg = inject_task_attrs(ModelConfig(**MODEL_KW, vocab_size=len(tok),
                                        num_labels=3), run)
    loader = common.build_eval_loader(ds, RetrievalCollator(tok, 8), run)
    eval_fn = steps.make_eval_step(
        cfg, run_vqa.make_task_settings(run, is_train=False), torch.float32)
    validate = run_vqa.build_validate(run, ds, loader, torch.float32)
    with _profile() as prof:
        metrics = validate(_model(cfg, "seq_cls"), eval_fn)
    assert len(metrics["results"]) == 6
    t = profiling.totals()
    want = {"vqa.validate": 1, "vqa.data_wait": 3, "vqa.dispatch": 2,
            "device_batch.copy": 2, "device_batch.preprocess": 2,
            "host_fetch.wait": 2, "loader.batch": 2}
    assert {k: t[k]["n"] for k in want} == want
    _assert_events_agree(prof, closed)
    shares = [t[k]["s"] / t["vqa.validate"]["s"]
              for k in ("vqa.data_wait", "device_batch.copy",
                        "host_fetch.wait")]
    assert shares[0] > 0 and shares[1] > 0 and sum(shares) <= 1.0
    # the main-thread stages sit directly under the call
    assert {s.parent.name for s, _ in closed if s.name in
            ("vqa.data_wait", "vqa.dispatch", "device_batch.copy")} == \
        {"vqa.validate"}
