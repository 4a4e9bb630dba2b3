"""The port's measurement tools (bench_train_step, bench_retrieval_eval,
bench_dataplane, train_convergence) on the CPU at a tiny width: each
tool's main() prints its JSON lines with their fields, and a tool that is
cut by its --deadline_s (a stage made to hang) prints one line with value
null and its timeout_stage, then ends the process with code 124; a stage
that fails prints value null with the failure. The convergence run's
orchestration is tests/test_torch_train_convergence.py."""

import functools
import json
import threading

import pytest
import torch

from clipbert_tpu_torch import (bench_dataplane, bench_retrieval_eval,
                                bench_train_step, train_convergence)
from clipbert_tpu_torch.tasks import run_video_retrieval
from clipbert_tpu_torch.utils import tool_run

TINY = dict(vocab_size=160, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, max_grid_row_position_embeddings=8,
            max_grid_col_position_embeddings=8)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Two threads: a worker of a parallel run shares the cores, and
    OpenMP's idle threads spin through the thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny_model.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_bench_train_step(tiny, capsys, tmp_path, monkeypatch):
    """One sweep configuration, the component split and the data plane
    (one timed step, its device-only rate the sweep's), at 1 video x 2
    clips of 64^2 frames."""
    monkeypatch.setattr(bench_train_step, "bench_data_plane",
                        functools.partial(bench_train_step.bench_data_plane,
                                          n_steps=1))
    recs = bench_train_step.main([
        "--device", "cpu", "--model_config", tiny, "--sweep", "1:1",
        "--components_batch", "1", "--n_clips", "2", "--num_frm", "1",
        "--img", "64", "--txt_len", "8", "--steps", "1", "--warmup", "0",
        "--data_plane", "--decoder", "jseq",
        "--data_plane_batch", "1", "--trace_dir", str(tmp_path / "trace")])
    assert _lines(capsys) == json.loads(json.dumps(recs))
    step, comp, plane = recs
    assert step["metric"] == "train_step" and step["update"] == "fused"
    assert step["flops_per_step"] > 0 and step["step_ms"] > 0
    assert step["mfu"] == pytest.approx(step["tf_per_sec"] / 989.0)
    c = comp["components"]
    for key in ("cnn_fwd_ms", "fwd_ms", "fwd_bwd_ms", "full_step_ms",
                "bwd_ms", "update_by_subtraction_ms", "update_fused_ms",
                "update_per_leaf_ms", "update_fused_launches",
                "update_per_leaf_launches", "step_launches"):
        assert key in c, key
    assert len(c["update_fused_ms"]) == len(c["update_per_leaf_ms"]) == 2
    assert 0 < len(c["top_ops"]) <= bench_train_step.TOP_OPS
    assert list((tmp_path / "trace").iterdir())          # the Chrome trace
    assert plane["metric"] == "train_data_plane"
    assert plane["decoder"] == "jseq" and plane["e2e_train_clips_per_sec"] > 0
    assert plane["device_train_clips_per_sec"] == step["clips_per_sec"]


def test_bench_retrieval_eval(tiny, capsys):
    rec = bench_retrieval_eval.main([
        "--device", "cpu", "--model_config", tiny, "--n_videos", "3",
        "--n_captions", "12", "--n_clips", "2", "--num_frm", "1",
        "--max_img_size", "64", "--quantize", "1"])
    assert _lines(capsys) == [json.loads(json.dumps(rec))]
    assert rec["quantize"] is True and rec["n_captions"] == 12
    assert rec["sec_per_video_vs_1000_caps"] == pytest.approx(
        rec["seconds"] / 3 * 1000 / 12)
    assert rec["full_1000x1000_seconds_est"] == pytest.approx(
        rec["sec_per_video_vs_1000_caps"] * 1000)
    assert rec["stage_stats"]["n_videos"] == 3
    # on the CPU every wrapper takes its plain version: no launch
    assert set(rec["launches"].values()) == {0}


def test_bench_dataplane(tiny, capsys):
    recs = bench_dataplane.main([
        "--device", "cpu", "--model_config", tiny, "--decoder", "jseq",
        "--n_videos", "3", "--n_clips", "2", "--num_frm", "1",
        "--max_img_size", "64", "--frames", "16"])
    assert _lines(capsys) == json.loads(json.dumps(recs))
    assert [r["metric"] for r in recs] == [
        "dataplane_host_decode_clips_per_sec",
        "dataplane_device_unit_clips_per_sec",
        "dataplane_end_to_end_clips_per_sec"]
    assert all(r["value"] > 0 and r["decoder"] == "jseq" for r in recs)
    assert recs[1]["source"].startswith("measured")
    assert recs[2]["stage_stats"]["n_videos"] == 3


class Hung(Exception):
    pass


# (tool, the attribute made to hang, argv): each cut in its first stage
CUTS = {
    "bench_train_step": (bench_train_step, bench_train_step, "bench_step",
                         ["--device", "cpu", "--sweep", "1:0"]),
    "bench_retrieval_eval": (bench_retrieval_eval, run_video_retrieval,
                             "inference_retrieval",
                             ["--device", "cpu", "--n_videos", "2",
                              "--n_captions", "4", "--n_clips", "1"]),
    "bench_dataplane": (bench_dataplane, bench_dataplane, "make_store",
                        ["--device", "cpu", "--decoder", "jseq"]),
    "train_convergence": (train_convergence, train_convergence,
                          "build_corpus", ["--smoke", "--steps", "8"]),
}


@pytest.mark.parametrize("tool", sorted(CUTS))
def test_cut_by_the_deadline(tool, tiny, capsys, monkeypatch):
    module, where, attr, argv = CUTS[tool]
    if tool == "bench_retrieval_eval":
        argv = argv + ["--model_config", tiny, "--max_img_size", "64"]
    codes, released = [], threading.Event()

    def hard_exit(code):
        codes.append(code)
        released.set()

    def hang(*a, **k):
        released.wait(60)
        raise Hung()

    monkeypatch.setattr(tool_run, "_hard_exit", hard_exit)
    monkeypatch.setattr(where, attr, hang)
    with pytest.raises(Hung):
        module.main(argv + ["--deadline_s", "0.5"])
    lines = _lines(capsys)
    assert codes == [tool_run.TIMEOUT_EXIT]
    assert len(lines) == 1
    line = lines[0]
    assert line["value"] is None and line["deadline_s"] == 0.5
    assert line["timeout_stage"] == line["stage"] and "failure" not in line


def test_a_failure_prints_its_line(capsys, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no store")

    monkeypatch.setattr(bench_dataplane, "make_store", boom)
    with pytest.raises(RuntimeError):
        bench_dataplane.main(["--device", "cpu", "--decoder", "jseq"])
    (line,) = _lines(capsys)
    assert line == {"metric": "dataplane", "value": None,
                    "stage": "store of 24 jseq videos",
                    "failure": "RuntimeError: no store"}


def test_a_missing_card_is_an_error(capsys, monkeypatch):
    monkeypatch.setattr(tool_run.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_train_step.main(["--sweep", "1:0"])
    (line,) = _lines(capsys)
    assert line["value"] is None and "CUDA" in line["failure"]
