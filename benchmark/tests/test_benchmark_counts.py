"""The analytic FLOP and byte counts against values worked by hand, and the
model count against torch's FlopCounterMode on the plain forms."""

import json

import pytest
import torch

from benchmark import harness, model_flops as mf
from benchmark.readers import kernel_roofline, mfu

ROOF = harness.BENCH / "rooflines"


def _kernel(name):
    return harness.load_module(ROOF / f"{name}.py", f"test_roof_{name}")


def _bound_ms(ops, nbytes):
    return max(ops / 989e12, nbytes / 3.35e12) * 1e3


def test_attention_count_at_the_eval_dispatch():
    ops, nbytes = _kernel("fused_attention").work((8192, 69, 12, 64, 2))
    assert ops == 4 * 8192 * 12 * 69 * 69 * 64
    assert nbytes == 4 * 8192 * 69 * 768 * 2 + 8192 * 69 * 4
    # the bound of PERF.md's kernel table: 1.0374 ms, set by bytes
    assert _bound_ms(ops, nbytes) == pytest.approx(1.0374, abs=1e-4)


def test_matmul_bn_act_count_with_stride_and_residual():
    k = _kernel("matmul_bn_act")
    # (32, 112, 112) x 64 -> 256 with a residual: R = 401408 rows
    ops, nbytes = k.work((32, 112, 112, 64, 256, 1, True, 2))
    R = 32 * 112 * 112
    assert ops == 2 * R * 64 * 256
    assert nbytes == (R * 64 + 64 * 256 + 2 * R * 256) * 2 + 256 * 4
    assert _bound_ms(ops, nbytes) == pytest.approx(0.1380, abs=1e-4)
    # stride 2 reads every other row and column: 28 x 28 of 56 x 56
    ops2, _ = k.work((1, 56, 56, 256, 512, 2, False, 2))
    assert ops2 == 2 * 28 * 28 * 256 * 512


def test_stem_count_at_448():
    ops, nbytes = _kernel("fused_stem_pool").work((32, 448, 448, 2))
    assert ops == 2 * 32 * 224 * 224 * 64 * 147
    assert nbytes == (32 * 448 * 448 * 3 + 32 * 112 * 112 * 64) * 2 \
        + 64 * 147 * 4 + 64 * 4
    assert _bound_ms(ops, nbytes) == pytest.approx(0.0305, abs=1e-4)


def test_bert_sequence_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
           "cls_hidden_scale": 2}
    S = 3
    layer = S * (4 * 16 + 2 * 4 * 8) + 2 * S * S * 4
    head = 16 + 4 * 8 + 8 * 5
    assert mf.bert_seq_flops(cfg, S, 5) == 2 * (2 * layer + head)


def test_grid_tokens_and_joint_lengths():
    assert mf.grid_tokens(448) == 49 and mf.grid_tokens(768) == 144
    for name, S in (("msrvtt_ret", 69), ("vqa", 164)):
        cfg = json.loads((harness.BENCH / "configs" / f"{name}.json")
                         .read_text())
        assert mf.joint_len(cfg) == S


def test_cnn_stem_and_first_conv_by_hand():
    # the stem alone, and the grid encoder alone, at 64 x 64
    assert mf.stem_flops(64, 64) == 2 * 32 * 32 * 64 * 3 * 49
    with_enc = mf.cnn_flops(64, 64, 10)
    assert with_enc - mf.cnn_flops(64, 64, 0) == 2 * 2 * 2 * 2048 * 10 * 9


@pytest.mark.parametrize("name,head,frames", [("msrvtt_ret", "retrieval", 2),
                                              ("vqa", "seq_cls", 1)])
def test_model_count_equals_flop_counter(name, head, frames):
    """One clip through the plain forms (cuDNN CNN, einsum attention) at a
    cut width: FlopCounterMode counts every product, as the analytic count
    does."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.drivers import _common as C
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.train import steps
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=2, max_img_size=128, vocab_size=100)
    n_out = 2 if head == "retrieval" else 7
    cfg["num_labels"] = n_out
    mcfg, _ = C.port_configs(cfg, n_out, device="cpu")
    model = clipbert.init_clipbert(
        mcfg, head, generator=torch.Generator().manual_seed(0),
        device="cpu").eval()
    S = cfg["max_img_size"]
    ts = steps.TaskSettings(head_type=head, num_labels=n_out,
                            loss_type=mcfg.loss_type, train_n_clips=1)
    L = cfg["max_txt_len"]
    batch = {"visual_inputs": torch.zeros(1, frames, S, S, 3),
             "text_input_ids": torch.ones(1, L, dtype=torch.long),
             "text_input_mask": torch.ones(1, L, dtype=torch.long)}
    with FlopCounterMode(display=False) as fc:
        steps.mil_forward(model, mcfg, ts, batch, torch.float32,
                          use_kernels=False, fused_attn=False)
    want = frames * mf.cnn_flops(S, S, 64) + mf.bert_seq_flops(
        cfg, mf.joint_len(cfg), n_out)
    assert fc.get_total_flops() == want


def test_train_count_is_three_forwards_less_the_stem_input_gradient():
    assert mf.train_flops(10.0, 1.0) == 29.0


def test_readers_on_a_hand_made_trace():
    from benchmark.devtrace import Trace
    t = Trace()
    t.window_s, t.busy_s, t.n_device_events = 2.0, 1.5, 3
    t.kernels = {"fused_attention_tc_kernel<5, 4>": [0.004, 2],
                 "other": [1.0, 1]}
    shape = (8192, 69, 12, 64, 2)
    run = {"device": {"kind": "NVIDIA H100 80GB HBM3"}, "trace": t,
           "window_s": 2.0, "work": {"model_flops": 989e12},
           "launch_shapes": {"fused_attention": [shape, shape]},
           "rooflines": {"fused_attention": _kernel("fused_attention")}}
    # two launches of a 1.0374 ms bound in 4 ms of device time
    assert kernel_roofline(run, "fused_attention") == pytest.approx(
        100 * 2 * 1.0374e-3 / 0.004, rel=1e-4)
    assert mfu(run) == pytest.approx(50.0)
    run["launch_shapes"]["fused_attention"].append(shape)
    assert kernel_roofline(run, "fused_attention") is None  # 3 vs 2
    run["device"]["kind"] = "cpu"
    assert mfu(run) is None
