"""Fixtures of the benchmark's CPU tests: each cell at a tiny size (the
published configuration with its widths cut and fp32 compute, so that the
port on the CPU equals the reference to round-off), and the ``card``
fixture that skips a test where no CUDA card is present.

    python -m pytest benchmark/tests -q            # the CPU tests
    python -m pytest benchmark/tests -q -m card    # on a machine with a card
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hidden_size": 32, "num_attention_heads": 2, "num_hidden_layers": 2,
        "intermediate_size": 64, "vocab_size": 300, "max_img_size": 64,
        "inference_n_clips": 2, "inference_batch_size": 8,
        "train_batch_size": 2, "train_n_clips": 2, "val_batch_size": 8,
        "bf16": 0}
# a cell whose driver is built and tested but which BENCHMARK.json does
# not hold yet (PERF.md, Open questions), with limits for the tests alone:
# at the tiny size in float32 the port reads ~1e-5 there, a fault 0.1-1
PENDING = {"msrvtt_ret.train_b16": (
    {"name": "msrvtt_ret.train_b16", "config": "msrvtt_ret",
     "traffic": "train_b16", "chips": 1, "why": "pending"},
    {"grad_norm_gap_median": 0.05, "change_gap_median": 0.05})}
TINY_TRAFFIC = {
    "eval_1kcap": {"captions": 20, "check_videos": 2, "check_captions": 6,
                   "check_caption_chunk": 4, "video_pool": 3},
    "eval_b32": {"questions_per_call": 32, "image_pool": 4, "keep_every": 2,
                 "check_batches": 2},
    "train_b16": {}}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def spec():
    """BENCHMARK.json with the pending cells added."""
    from benchmark import harness
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec["workloads"] += [cell for cell, _ in PENDING.values()]
    return spec


class Tiny:
    """A cell of BENCHMARK.json with its configuration and traffic cut to
    a CPU test's size; the limits stay the cell's own."""

    def __init__(self, spec, name):
        from benchmark import harness
        self.name = name
        self.limits = PENDING[name][1] if name in PENDING else None
        self.cell, centry = harness.find_cell(spec, name)
        cfg = copy.deepcopy(harness.load_json(harness.ROOT / centry["file"]))
        for k, v in TINY.items():
            if k in cfg:
                cfg[k] = v
        if "num_labels" in cfg:
            cfg["num_labels"] = 16
        a = cfg["assumed"]
        for k in ("stub_frame_hw", "stub_image_hw"):
            if k in a:
                a[k] = [30, 40]
        if "inference_video_batch_size" in a:
            a["inference_video_batch_size"] = 2
        self.config = cfg
        traffic = harness.load_json(
            harness.BENCH / "traffic" / f"{self.cell['traffic']}.json")
        traffic.update(TINY_TRAFFIC[self.cell["traffic"]])
        self.traffic = traffic


@pytest.fixture(params=["msrvtt_ret.eval_1kcap", "vqa.eval_b32",
                        "msrvtt_ret.train_b16"])
def tiny(request, spec):
    return Tiny(spec, request.param)
