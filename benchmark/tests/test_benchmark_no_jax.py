"""No run of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the port either: each is run in a fresh interpreter with
those packages blocked, and its modules are compared by whole top-level
name (``clipbert_tpu_torch`` is not ``clipbert_tpu``)."""

import subprocess
import sys
import textwrap
import types

from benchmark import harness

BLOCK = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    BLOCKED = {blocked!r}
    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None
    sys.meta_path.insert(0, Blocker())
""")


def _fresh(body: str, blocked) -> subprocess.CompletedProcess:
    code = BLOCK.format(root=str(harness.ROOT),
                        tests=str(harness.BENCH / "tests"),
                        blocked=tuple(blocked)) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)


def test_a_run_loads_no_jax():
    r = _fresh("""
        import io, json, time, torch
        torch.set_num_threads(2)
        from benchmark import harness
        from conftest import PENDING, Tiny
        spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
        spec["workloads"] += [cell for cell, _ in PENDING.values()]
        for name in ("msrvtt_ret.eval_1kcap", "vqa.eval_b32",
                     "msrvtt_ret.train_b16"):
            t = Tiny(spec, name)
            out = io.StringIO()
            rc = harness.run_cell(name, 3, 0.1, False,
                                  t_start=time.perf_counter(), spec=spec,
                                  device=torch.device("cpu"),
                                  require_chips=False,
                                  config_override=t.config,
                                  traffic_override=t.traffic, out=out)
            assert rc == 0, out.getvalue()
        tops = sorted({m.split(".", 1)[0] for m in sys.modules})
        print("TOPS", " ".join(tops))
    """, harness.FORBIDDEN)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = r.stdout.split("TOPS", 1)[1].split()
    assert "clipbert_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    r = _fresh("""
        import torch
        from benchmark.reference import clipbert_ref as ref
        from benchmark import weights
        cfg = {"hidden_size": 8, "intermediate_size": 16,
               "num_hidden_layers": 1, "num_attention_heads": 2,
               "layer_norm_eps": 1e-12, "vocab_size": 40,
               "max_position_embeddings": 32, "type_vocab_size": 2,
               "max_grid_row_position_embeddings": 4,
               "max_grid_col_position_embeddings": 4,
               "backbone_channel_in_size": 2048, "initializer_range": 0.02,
               "pad_token_id": 0, "max_img_size": 64, "max_txt_len": 6,
               "img_pixel_mean": [1.0, 2.0, 3.0], "img_pixel_std": [1, 1, 1],
               "img_input_format": "BGR", "loss_type": "ce"}
        w = weights.make_weights(cfg, "retrieval", 1, torch.device("cpu"))
        frames = torch.zeros(2, 30, 40, 3, dtype=torch.uint8)
        grids = ref.video_grids(w, cfg, frames, 1)
        ids = torch.tensor([[2, 5, 3, 0, 0, 0]])
        pooled = ref.retrieval_pooled(w, cfg, grids, ids, (ids > 0).long())
        assert pooled.shape == (1, 2)
        print("TOPS", " ".join(sorted({m.split(".", 1)[0]
                                       for m in sys.modules})))
    """, harness.FORBIDDEN + ("clipbert_tpu_torch",))
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(r.stdout.split("TOPS", 1)[1].split())
    assert not tops & (set(harness.FORBIDDEN) | {"clipbert_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("clipbert_tpu_torch", "clipbert_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "clipbert_tpu.models",
                        types.ModuleType("clipbert_tpu.models"))
    assert harness.forbidden_modules() == ["clipbert_tpu"]
