"""The port never imports jax (nor clipbert_tpu, whose __init__ imports
jax), and on tensors that lie on the CPU the fused-attention wrapper takes
its plain version without counting a kernel launch. Checked in a fresh
interpreter: this test process has imported jax already (conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import clipbert_tpu_torch
for m in pkgutil.walk_packages(clipbert_tpu_torch.__path__,
                               "clipbert_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import clipbert_tpu_torch.serve
bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")
       or n == "clipbert_tpu" or n.startswith("clipbert_tpu.")]
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
assert "jax" not in sys.modules
print("PORT_OK")
"""


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
