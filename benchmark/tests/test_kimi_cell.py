"""The Kimi-VL cell (``kimi_vl_a3b_ret.eval_32cap``) at a tiny size on the
CPU: the published layout with its widths cut (hidden 64, 4 heads, q/k
24 = 16 + 8, v 16, kv rank 32, 16 experts of width 32, top 4, one shared,
layer 0 dense) and float32 compute, so the port equals the reference to
round-off, against the cell's own limits. Two wiring faults planted under
the router, top-(k-1) routing and the correction bias dropped from the
choice, must land outside them; and a traced run leaves out the readers
that find nothing on the CPU."""

import copy
import io
import json
import time

import pytest
import torch

from benchmark import harness

CELL = "kimi_vl_a3b_ret.eval_32cap"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
        "n_routed_experts": 16, "num_experts_per_tok": 4,
        "n_shared_experts": 1, "moe_intermediate_size": 32,
        "intermediate_size": 96, "num_hidden_layers": 3,
        "vocab_size": 300, "max_img_size": 64, "inference_n_clips": 2,
        "inference_batch_size": 8, "bf16": 0}
NEW_READERS = ("mfu.kimi", "device_idle_share.kimi",
               "moe_gemm_roofline.kimi", "mla_attention_roofline.kimi",
               "moe_kernel_share.kimi", "dense_kernel_share.kimi",
               "matmul_bn_act_roofline.kimi", "fused_stem_pool_roofline.kimi")
# read from the retrieval loop's own stats and spans, on any device
LOOP_READERS = ("host_wait_share.kimi", "call_setup_share.kimi")


def _tiny(spec):
    _, centry = harness.find_cell(spec, CELL)
    cfg = copy.deepcopy(harness.load_json(harness.ROOT / centry["file"]))
    cfg.update(TINY)
    cfg["assumed"]["inference_video_batch_size"] = 2
    cfg["assumed"]["stub_frame_hw"] = [30, 40]
    traffic = harness.load_json(harness.BENCH / "traffic" / "eval_32cap.json")
    traffic.update({"captions": 16, "video_pool": 3})
    return cfg, traffic


def _run(spec, trace=False):
    cfg, traffic = _tiny(spec)
    out = io.StringIO()
    rc = harness.run_cell(CELL, 2**31 + 91, 0.2, trace,
                          t_start=time.perf_counter(), spec=spec,
                          device=torch.device("cpu"), require_chips=False,
                          config_override=cfg, traffic_override=traffic,
                          out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def spec():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_tiny_cell_is_correct_and_traced_readers_stay_silent(spec):
    rc, line = _run(spec, trace=True)
    assert rc == 0 and line["correct"] is True, line
    checks = line["checks"]
    assert checks["route_mismatch"]["value"] == 0
    assert checks["moe_rel_rms"]["value"] < 1e-4
    names = {m["name"] for m in harness.cell_metrics(spec, "per_layer",
                                                     CELL)}
    assert set(NEW_READERS) <= names
    assert set(LOOP_READERS) <= names
    # no card: no peak, no device trace, no CUDA call counted; the loop's
    # stats and spans are there on any device
    assert not set(NEW_READERS) & set(line["metrics"])
    for name in LOOP_READERS:
        assert 0 < line["metrics"][name]["value"] < 100


@pytest.mark.parametrize("fault", ["top_k_less_one", "bias_dropped"])
def test_planted_routing_faults_fail_the_check(spec, fault, monkeypatch):
    from clipbert_tpu_torch.ops import moe
    route = moe.route

    def faulty(x, gate_weight, bias, top_k, scaling, norm_topk):
        if fault == "top_k_less_one":
            top_k -= 1
        else:
            bias = torch.zeros_like(bias)
        return route(x, gate_weight, bias, top_k, scaling, norm_topk)

    monkeypatch.setattr(moe, "route", faulty)
    rc, line = _run(spec)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["route_mismatch"]["value"] > 0


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"benchmark_metric_{name}")


@pytest.mark.parametrize("grouped,plain,want", [
    (52, 0, 100.0), (3, 1, 75.0), (0, 4, 0.0), (0, 0, None)])
def test_moe_share_on_made_up_counts(grouped, plain, want, monkeypatch):
    from clipbert_tpu_torch.ops import moe
    monkeypatch.setattr(moe, "MOE_GROUPED_CALLS", grouped)
    monkeypatch.setattr(moe, "MOE_PLAIN_CALLS", plain)
    got = _reader("moe_kernel_share.kimi").read({})
    assert got == (None if want is None else pytest.approx(want))


def test_share_readers_without_the_program_counters(monkeypatch):
    """A program without the expert layer or dense's counters (the parent
    commit): nothing to read, and no error."""
    from clipbert_tpu_torch.ops import linear, moe
    monkeypatch.delattr(moe, "MOE_GROUPED_CALLS")
    monkeypatch.delattr(linear, "DENSE_KERNEL_CALLS")
    assert _reader("moe_kernel_share.kimi").read({}) is None
    assert _reader("dense_kernel_share.kimi").read({}) is None


def test_rooflines_count_the_dispatch():
    """At one caption dispatch: 141,312 tokens x 6 rows of 2048 -> 2816 in
    the grouped gate|up launch; latent attention over 2048 sequences of 69
    tokens, 16 heads, the causal half of the (query, key) pairs."""
    moe_rf = harness.load_module(harness.BENCH / "rooflines" /
                                 "moe_grouped_gemm.py", "rf_moe")
    ops, nbytes = moe_rf.work((141312 * 6, 2048, 2816, 64, 2))
    assert ops == 2.0 * 847872 * 2048 * 2816
    assert nbytes == (847872 * (2048 + 2816) + 64 * 2816 * 2048) * 2
    mla_rf = harness.load_module(harness.BENCH / "rooflines" /
                                 "mla_attention.py", "rf_mla")
    ops, nbytes = mla_rf.work((2048, 69, 16, 192, 128, True, 2))
    assert ops == 2.0 * 2048 * 16 * (69 * 70 / 2) * 320
    assert nbytes == 2048 * 69 * 16 * 640 * 2 + 2048 * 69 * 4
    q = torch.empty(2048, 69, 16, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(2048, 69, 16, 128, dtype=torch.bfloat16, device="meta")
    bias = torch.empty(2048, 69, device="meta")
    # attention_core(q, k, v, key_bias, scale, fused): always causal
    assert mla_rf.shape((q, q, v, bias, 192 ** -0.5, True), {}) == \
        (2048, 69, 16, 192, 128, True, 2)
    assert (mla_rf.MODULE, mla_rf.FUNCTION) == (
        "clipbert_tpu_torch.models.deepseek_v3", "attention_core")
    full, _ = mla_rf.work((2048, 69, 16, 192, 128, False, 2))
    assert full == 2.0 * 2048 * 16 * 69 * 69 * 320


def test_reference_copy_is_the_tests_reference():
    """benchmark/reference/kimi_vl_lm_ref.py is tests/kimi_vl_lm_ref.py, the
    plain reference the CPU tests hold the port to; it imports torch
    alone."""
    import ast
    bench = (harness.BENCH / "reference" / "kimi_vl_lm_ref.py").read_text()
    tests = (harness.ROOT / "tests" / "kimi_vl_lm_ref.py").read_text()
    assert bench == tests
    mods = set()
    for node in ast.walk(ast.parse(bench)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "typing", "torch"}
