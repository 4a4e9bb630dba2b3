"""The per-layer readers of ``ops/linear.py::dense``'s counters
(``benchmark/metrics/`` ``dense_kernel_share.eval``,
``dense_kernel_share.vqa``): each on made-up counts, None where no CUDA
call was counted or the program has no such counters; and the traced CPU
run of each eval cell, in which they find nothing (CPU calls count
nothing)."""

import io
import json
import time

import pytest
import torch

from benchmark import harness
from clipbert_tpu_torch.ops import linear

READERS = {"dense_kernel_share.eval": "msrvtt_ret.eval_1kcap",
           "dense_kernel_share.vqa": "vqa.eval_b32"}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"benchmark_metric_{name}")


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("kernel,plain,want", [
    (12, 0, 100.0), (3, 1, 75.0), (0, 4, 0.0), (0, 0, None)])
def test_reader_on_made_up_counts(name, kernel, plain, want, monkeypatch):
    monkeypatch.setattr(linear, "DENSE_KERNEL_CALLS", kernel)
    monkeypatch.setattr(linear, "DENSE_PLAIN_CALLS", plain)
    got = _reader(name).read({})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("missing", ["DENSE_KERNEL_CALLS",
                                     "DENSE_PLAIN_CALLS"])
def test_reader_without_the_counters(name, missing, monkeypatch):
    """The parent commit's program has no such counters: nothing to read,
    and no error."""
    monkeypatch.delattr(linear, missing)
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_traced_cpu_run_reads_no_share(name, spec, monkeypatch):
    """A traced run of the cell at a tiny size on the CPU: dense runs the
    unfused formula there and counts no call, so the share is left out of
    the line."""
    from conftest import Tiny
    cell = READERS[name]
    monkeypatch.setattr(linear, "DENSE_KERNEL_CALLS", 0)
    monkeypatch.setattr(linear, "DENSE_PLAIN_CALLS", 0)
    tiny = Tiny(spec, cell)
    out = io.StringIO()
    rc = harness.run_cell(cell, 2**31 + 778, 0.2, True,
                          t_start=time.perf_counter(), spec=spec,
                          device=torch.device("cpu"), require_chips=False,
                          config_override=tiny.config,
                          traffic_override=tiny.traffic, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert name in {m["name"] for m in harness.cell_metrics(
        spec, "per_layer", cell)}
    assert name not in line["metrics"]
    assert (linear.DENSE_KERNEL_CALLS, linear.DENSE_PLAIN_CALLS) == (0, 0)
