"""The per-layer readers of the program's spans (``benchmark/metrics/``
``host_wait_share.vqa``, ``copy_share.vqa``, ``fetch_wait_share.vqa``,
``loader_busy_share.vqa``, ``call_setup_share.eval``): each on a made-up
``totals()``, None where its span or its denominator has no time or the
program has no span facility; and the traced CPU run of each eval cell,
in which every program counter of the cell reads a number."""

import io
import json
import time

import pytest
import torch

from benchmark import harness
from clipbert_tpu_torch.utils import profiling

# reader -> (its span, its denominator span, the traffic's thread count)
READERS = {"host_wait_share.vqa": ("vqa.data_wait", "vqa.validate", 1),
           "copy_share.vqa": ("device_batch.copy", "vqa.validate", 1),
           "fetch_wait_share.vqa": ("host_fetch.wait", "vqa.validate", 1),
           "loader_busy_share.vqa": ("loader.batch", "vqa.validate", 2),
           "call_setup_share.eval": ("retrieval.setup", "retrieval.call",
                                     1)}
RUN = {"traffic": {"loader_workers": 2}}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"benchmark_metric_{name}")


def _totals(**seconds):
    return {k: {"s": s, "n": 1, "self_s": s} for k, s in seconds.items()}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_made_up_totals(name, monkeypatch):
    part, whole, threads = READERS[name]
    read = _reader(name).read
    cases = [(_totals(**{part: 0.5, whole: 4.0, "other": 9.0}),
              100.0 * 0.5 / (4.0 * threads)),
             (_totals(**{whole: 4.0}), None),
             (_totals(**{part: 0.0, whole: 4.0}), None),
             (_totals(**{part: 0.5}), None),
             ({}, None)]
    for t, want in cases:
        monkeypatch.setattr(profiling, "totals", lambda t=t: t)
        got = read(RUN)
        assert got == (None if want is None else pytest.approx(want)), t


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_span_facility(name, monkeypatch):
    """The parent commit's program has no ``totals``: nothing to read, and
    no error."""
    monkeypatch.delattr(profiling, "totals")
    assert _reader(name).read(RUN) is None


@pytest.mark.parametrize("cell", ["msrvtt_ret.eval_1kcap", "vqa.eval_b32"])
def test_traced_run_reads_every_program_counter(cell, spec, monkeypatch):
    """A traced run of the cell at a tiny size on the CPU: with no card
    only the program counters have something to read, and each does; the
    VQA main thread's three waits are disjoint shares of its calls."""
    from conftest import Tiny
    monkeypatch.setattr(profiling, "_TOTALS", {})
    tiny = Tiny(spec, cell)
    out = io.StringIO()
    rc = harness.run_cell(cell, 2**31 + 777, 0.2, True,
                          t_start=time.perf_counter(), spec=spec,
                          device=torch.device("cpu"), require_chips=False,
                          config_override=tiny.config,
                          traffic_override=tiny.traffic, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    want = {m["name"] for m in harness.cell_metrics(spec, "per_layer", cell)
            if m["source"] == "program_counter"}
    assert set(line["metrics"]) == want
    values = {k: v["value"] for k, v in line["metrics"].items()}
    assert all(0.0 < v <= 100.0 for v in values.values()), values
    if cell == "vqa.eval_b32":
        assert values["host_wait_share.vqa"] + values["copy_share.vqa"] \
            + values["fetch_wait_share.vqa"] <= 100.0
