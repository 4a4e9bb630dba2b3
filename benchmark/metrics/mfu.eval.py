"""The whole retrieval eval window's share (%) of the card's bf16 peak,
from the analytic FLOPs of the work it did (benchmark/model_flops.py)."""

from benchmark.readers import mfu


def read(run):
    return mfu(run)
