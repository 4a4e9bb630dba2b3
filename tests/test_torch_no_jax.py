"""The port never imports jax (nor clipbert_tpu, whose __init__ imports
jax): every module of clipbert_tpu_torch, and chip_smoke.py, imports with
both blocked. On tensors that lie on the CPU each kernel wrapper takes its
plain version without counting a kernel launch. Checked in a fresh
interpreter: this test process has imported jax already (conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "clipbert_tpu"):
    sys.modules[blocked] = None          # importing it now raises ImportError
import clipbert_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clipbert_tpu_torch.__path__,
                                               "clipbert_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in NEW_MODULES:
    assert name in names, name
import chip_smoke
bad = [n for n, m in sys.modules.items() if m is not None and (
       n == "jax" or n.startswith("jax.") or n == "clipbert_tpu"
       or n.startswith("clipbert_tpu."))]
assert not bad, bad

import torch
from clipbert_tpu_torch.ops import fused_attention as fa
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(3, 9, 2, 16, generator=g) for _ in range(3))
bias = torch.zeros(3, 9)
bias[:, 5:] = -10000.0
out = fa.fused_attention(q, k, v, bias, 0.25)
assert torch.equal(out, fa.fused_attention_reference(q, k, v, bias, 0.25))
assert fa.LAUNCHES == 0, fa.LAUNCHES

from clipbert_tpu_torch.ops import fused_stem_pool as fsp
from clipbert_tpu_torch.ops import matmul_bn_act as mba
x = torch.randn(2, 5, 6, 8, generator=g)
w = torch.randn(16, 8, 1, 1, generator=g)
b = torch.randn(16, generator=g)
out = mba.conv1x1_bn_act(x, w, None, b, stride=2)
assert torch.equal(out, mba.matmul_bn_act_reference(
    x[:, ::2, ::2].reshape(-1, 8), w.reshape(16, 8).t(), None, b
    ).reshape(2, 3, 3, 16))
px = torch.randn(1, 19, 23, 3, generator=g)
sw = torch.randn(64, 3, 7, 7, generator=g)
sb = torch.randn(64, generator=g)
assert torch.equal(fsp.fused_stem_pool(px, sw, sb),
                   fsp.fused_stem_pool_reference(px, sw, sb))
assert mba.LAUNCHES == 0 and fsp.LAUNCHES == 0
assert sys.modules["jax"] is None
print("PORT_OK")
"""
# modules the later slices of the port added; the walk above must reach
# them all
NEW_MODULES = ["clipbert_tpu_torch.core.mesh",
               "clipbert_tpu_torch.utils.distributed",
               "clipbert_tpu_torch.parallel",
               "clipbert_tpu_torch.parallel.sharding",
               "clipbert_tpu_torch.ops.matmul_bn_act",
               "clipbert_tpu_torch.ops.fused_stem_pool",
               "clipbert_tpu_torch.evaluation.metrics",
               "clipbert_tpu_torch.data.store",
               "clipbert_tpu_torch.data.datasets",
               "clipbert_tpu_torch.ckpt.checkpoint",
               "clipbert_tpu_torch.tasks.common",
               "clipbert_tpu_torch.tasks.run_video_retrieval",
               "clipbert_tpu_torch.utils.basic",
               "clipbert_tpu_torch.data.loader",
               "clipbert_tpu_torch.tasks.run_msrvtt_mc",
               "clipbert_tpu_torch.tasks.run_video_qa",
               "clipbert_tpu_torch.tasks.run_vqa",
               "clipbert_tpu_torch.ops.dropout",
               "clipbert_tpu_torch.core.rng",
               "clipbert_tpu_torch.train.sched",
               "clipbert_tpu_torch.train.optim",
               "clipbert_tpu_torch.train.trainer",
               "clipbert_tpu_torch.utils.logger",
               "clipbert_tpu_torch.utils.profiling"]
_CHECK = _CHECK.replace("NEW_MODULES", repr(NEW_MODULES))


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_cpu_takes_plain_version():
    proc = _run(["-c", _CHECK], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PORT_OK" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    """No CUDA device here: chip_smoke.py must exit non-zero and print no
    result line."""
    proc = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
