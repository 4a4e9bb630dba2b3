"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` into a shared library under ``clipbert_tpu_torch/
_build/`` (listed in .gitignore) whose file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. The library is loaded with ``ctypes``; callers declare
the argument types of the functions they call.

Nothing here runs at import time: the package must import, and its CPU
tests run, on hosts with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc "
                           "on PATH) to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_libraries(names) -> Dict[str, Path]:
    """Build every missing ``csrc/<name>.cu`` of ``names``, one ``nvcc``
    per source, all started together; returns {name: library path}. A
    failed build raises with nvcc's output; the compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    paths = {name: _target(name) for name in names}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed with exit code {proc.returncode}: "
                          f"{' '.join(cmd)}\n{log}")
            continue
        so = paths[name]
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent build never sees a torn file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library_path(name: str) -> Path:
    """The shared library for ``csrc/<name>.cu``, built if missing."""
    return build_libraries([name])[name]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(library_path(name)))
