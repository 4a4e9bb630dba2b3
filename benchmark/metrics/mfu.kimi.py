"""The whole Kimi-VL retrieval eval window's share (%) of the card's bf16
peak, from the analytic FLOPs of the work it did
(benchmark/kimi_flops.py, model_flops.py).

The count is of the work the program does, not the least work the scores
need: of a joint sequence's 69 tokens the first 49 are a clip's visual
tokens, which under the causal mask attend to one another alone, so their
hidden states are the same for all 16 captions a dispatch scores against
the clip. They are 71.0% of the language model's FLOPs at S = 69, and 15
of every 16 copies (66.5% of them) are recomputed work."""

from benchmark.readers import mfu


def read(run):
    return mfu(run)
