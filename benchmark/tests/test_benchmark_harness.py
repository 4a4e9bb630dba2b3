"""Each cell's driver at a tiny size on the CPU through the harness: a
sound run comes out correct against the cell's own limits, a run with a
fault planted under the timed path comes out not correct, and the last
line says what failed when a run fails or hangs."""

import io
import json
import time
import types

import pytest
import torch

from benchmark import control, faults, harness

CPU = torch.device("cpu")
# the faults each cell's timed path can have (benchmark/faults.py)
CELL_FAULTS = {"msrvtt_ret.eval_1kcap": ["altered_answer"],
               "vqa.eval_b32": ["altered_answer"],
               "msrvtt_ret.train_b16": ["half_batch", "unchanged_state"]}


def _run(tiny, spec, trace=False, **kw):
    out = io.StringIO()
    rc = harness.run_cell(tiny.name, 2**31 + 12345, 0.2, trace,
                          t_start=time.perf_counter(), spec=spec, device=CPU,
                          require_chips=False, config_override=tiny.config,
                          traffic_override=tiny.traffic,
                          limits_override=tiny.limits, out=out, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


def test_sound_run_is_correct(tiny, spec):
    rc, line, _ = _run(tiny, spec)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in harness.cell_metrics(spec, "end_to_end",
                                                    tiny.name)}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert c["limit"] is not None and c["value"] <= c["limit"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_planted_fault_is_not_correct(tiny, spec):
    for fault in CELL_FAULTS[tiny.name]:
        with faults.planted(fault):
            rc, line, _ = _run(tiny, spec)
        assert rc == 0
        assert line["correct"] is False, (fault, line["checks"])


def test_traced_run_reads_its_metrics(spec):
    from conftest import Tiny
    tiny = Tiny(spec, "msrvtt_ret.eval_1kcap")
    rc, line, _ = _run(tiny, spec, trace=True)
    assert rc == 0 and line["correct"] is True
    # no card: only the program counter has something to read
    assert set(line["metrics"]) == {"host_wait_share.eval"}
    assert 0.0 <= line["metrics"]["host_wait_share.eval"]["value"] <= 100.0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_reads_far_above_the_program(spec):
    from conftest import Tiny
    for name in ("msrvtt_ret.eval_1kcap", "vqa.eval_b32"):
        tiny = Tiny(spec, name)
        got = {}
        for mode in ("program", "control"):
            rows = control.readings(name, mode, [7], 0.1, device=CPU,
                                    config_override=tiny.config,
                                    traffic_override=tiny.traffic,
                                    out=io.StringIO())
            got[mode] = rows[0]["numbers"]
        for key, value in got["program"].items():
            assert got["control"][key] > 10 * value, (name, key, got)


def _fake_cell(monkeypatch, driver):
    real = harness.load_cell

    def load_cell(spec, name, root=harness.ROOT):
        cell, config, traffic, _, limits = real(spec, name, root)
        return cell, config, traffic, driver, limits

    monkeypatch.setattr(harness, "load_cell", load_cell)


def test_failure_prints_a_failed_line(monkeypatch, spec):
    def window(state, ctx):
        raise RuntimeError("kernel launch failed")

    _fake_cell(monkeypatch, types.SimpleNamespace(
        setup=lambda ctx: object(), window=window))
    out = io.StringIO()
    rc = harness.run_cell("vqa.eval_b32", 1, 0.1, False,
                          t_start=time.perf_counter(), spec=spec, device=CPU,
                          require_chips=False, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 1
    assert line["correct"] is False
    assert "kernel launch failed" in line["error"]
    assert "window" in line["error"]


def test_hang_prints_a_failed_line_and_exits_124(monkeypatch, spec):
    exits = []

    def window(state, ctx):
        deadline = time.time() + 10
        while not exits and time.time() < deadline:
            time.sleep(0.05)
        raise SystemExit("stopped by the test")

    _fake_cell(monkeypatch, types.SimpleNamespace(
        setup=lambda ctx: object(), window=window))
    out = io.StringIO()
    with pytest.raises(SystemExit):
        harness.run_cell("vqa.eval_b32", 1, 0.1, False,
                         t_start=time.perf_counter(), spec=spec, device=CPU,
                         require_chips=False, out=out, deadline_s=0.5,
                         hard_exit=exits.append)
    assert exits == [harness.TIMEOUT_EXIT]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is False
    assert "timeout" in line["error"] and "window" in line["error"]


def test_no_card_prints_no_result(spec):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = io.StringIO()
    rc = harness.run_cell("vqa.eval_b32", 1, 0.1, False,
                          t_start=time.perf_counter(), spec=spec, out=out)
    assert rc != 0 and out.getvalue() == ""


def test_without_the_program_prints_no_result(monkeypatch, spec):
    monkeypatch.setattr(harness, "PROGRAM", "no_such_package_here")
    out = io.StringIO()
    rc = harness.run_cell("vqa.eval_b32", 1, 0.1, False,
                          t_start=time.perf_counter(), spec=spec, device=CPU,
                          require_chips=False, out=out)
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.card
def test_control_fails_on_the_card(card, spec):
    """The control at each cell's own size on three seeds: every run fails
    one of the cell's numbers (minutes a cell)."""
    for cell in harness.load_json(harness.ROOT / "BENCHMARK.json")[
            "workloads"]:
        _, _, _, _, limits = harness.load_cell(spec, cell["name"])
        rows = control.readings(cell["name"], "control", [901, 902, 903],
                                1.0, device=card, out=io.StringIO())
        for row in rows:
            assert any(v > limits[k] for k, v in row["numbers"].items()
                       if k in limits), row
