"""The share (%) of the traced Kimi-VL retrieval eval window in which no
operation ran on the device (torch.profiler)."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
