# Copied from clipbert_tpu/utils/logger.py (every member; TensorboardLogger.create falls back to the added JsonlScalarWriter): JAX-free host code.
"""Logging / metrics observability.

Reference equivalents (`src/utils/logger.py`):
 - global LOGGER with optional file handler (:9-19)
 - TensorBoard wrapper carrying a global_step, no-op before creation (:22-61)
 - RunningMeter EMA smoothing 0.99 (:67-89)
 - NoOp object for non-main processes (`misc.py:12-19`)
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

_LOG_FMT = "%(asctime)s - %(levelname)s - %(name)s -   %(message)s"
_DATE_FMT = "%m/%d/%Y %H:%M:%S"
logging.basicConfig(format=_LOG_FMT, datefmt=_DATE_FMT, level=logging.INFO)
LOGGER = logging.getLogger("clipbert_tpu_torch")


def add_log_to_file(log_path: str) -> None:
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(fh)


class NoOp:
    """Swallows every call — installed on non-main hosts (misc.py:12-19)."""

    def __getattr__(self, name):
        return self.noop

    def noop(self, *args, **kwargs):
        return


class TensorboardLogger:
    """global_step-carrying TB writer; safe no-op before create()
    (logger.py:22-61). Uses torch's pure-python SummaryWriter on host."""

    def __init__(self):
        self._writer = None
        self.global_step = 0

    def create(self, path: str) -> None:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            # no tensorboard package: keep every scalar anyway, as JSON
            # lines, rather than drop the training logs
            LOGGER.warning(f"tensorboard is not installed ({e}); writing "
                           f"the scalars to {path}/scalars.jsonl instead")
            self._writer = JsonlScalarWriter(path)
            return
        self._writer = SummaryWriter(path)

    def noop(self, *args, **kwargs):
        return

    def step(self) -> None:
        self.global_step += 1

    def log_scalar_dict(self, log_dict: Dict[str, float],
                        prefix: str = "") -> None:
        if self._writer is None:
            return
        if prefix:
            prefix = f"{prefix}_"
        for k, v in log_dict.items():
            if isinstance(v, dict):
                self.log_scalar_dict(v, prefix=f"{prefix}{k}")
            else:
                self._writer.add_scalar(f"{prefix}{k}", float(v),
                                        self.global_step)

    def add_scalar(self, name: str, value: float,
                   step: Optional[int] = None) -> None:
        if self._writer is None:
            return
        self._writer.add_scalar(
            name, float(value),
            self.global_step if step is None else step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()


class JsonlScalarWriter:
    """The two SummaryWriter calls the logger makes, writing one JSON line
    {"tag", "value", "step"} per scalar to ``<path>/scalars.jsonl``."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._f = open(os.path.join(path, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")

    def flush(self) -> None:
        self._f.flush()


TB_LOGGER = TensorboardLogger()


class RunningMeter:
    """EMA-smoothed loss meter (logger.py:67-89), smooth=0.99."""

    def __init__(self, name: str, val: Optional[float] = None,
                 smooth: float = 0.99):
        self._name = name
        self._smooth = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        val = (value if self._val is None
               else value * (1 - self._smooth) + self._val * self._smooth)
        if val == val:  # NaN guard like the reference
            self._val = val

    def __str__(self) -> str:
        return f"{self._name}: {self._val:.4f}"

    @property
    def val(self) -> Optional[float]:
        return self._val

    @property
    def name(self) -> str:
        return self._name
