"""fused_attention's latent-attention launches (q/k 192, v 128, causal) in
the traced Kimi-VL retrieval eval window, as a share (%) of their
roofline bound (benchmark/rooflines/mla_attention.py) over their device
time."""

from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "mla_attention")
