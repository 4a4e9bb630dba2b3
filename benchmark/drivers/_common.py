"""What the drivers share: the port's two configurations built from a
benchmark configuration file, a vocabulary of the configured size, seeded
texts as both the strings the program tokenizes and the ids the reference
reads, and seeded frames."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
PAD, CLS, SEP = 0, 2, 3
FIRST_WORD = len(SPECIALS)


def rng(*keys: int) -> np.random.Generator:
    """A numpy generator for one purpose, from the seed and integer keys."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(k) % (1 << 63) for k in keys]))


def port_configs(cfg: Dict, head_labels: int, **run_overrides):
    """(ModelConfig, RunConfig) of the port from a configuration file's
    keys, the task attributes injected as the runners inject them."""
    from clipbert_tpu_torch.core.config import (ModelConfig, RunConfig,
                                                inject_task_attrs)
    mfields = {f.name for f in dataclasses.fields(ModelConfig)}
    rfields = {f.name for f in dataclasses.fields(RunConfig)}
    run = RunConfig(**{k: v for k, v in cfg.items() if k in rfields})
    run = run.replace(model_config="", num_labels=head_labels,
                      **run_overrides)
    model = ModelConfig(**{k: v for k, v in cfg.items() if k in mfields})
    return inject_task_attrs(model, run), run


def tokenizer(vocab_size: int):
    """The port's BertTokenizer over a vocabulary of ``vocab_size``
    entries: the five specials, then the words ``w5`` ... Word ``w<i>``
    has id i."""
    from clipbert_tpu_torch.data.tokenization import BertTokenizer
    words = list(SPECIALS) + [f"w{i}" for i in range(FIRST_WORD, vocab_size)]
    with tempfile.TemporaryDirectory(prefix="bench_vocab_") as d:
        path = os.path.join(d, "vocab.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(words) + "\n")
        return BertTokenizer(path)


def texts(g: np.random.Generator, n: int, words: Sequence[int],
          vocab_size: int) -> List[np.ndarray]:
    """``n`` texts of words[0] to words[1] word ids each, drawn from every
    word of the vocabulary."""
    lens = g.integers(words[0], words[1] + 1, n)
    ids = g.integers(FIRST_WORD, vocab_size, int(lens.sum()))
    return np.split(ids, np.cumsum(lens)[:-1])


def as_string(word_ids: np.ndarray) -> str:
    return " ".join(f"w{i}" for i in word_ids)


def as_ids(texts_: Sequence[np.ndarray], max_len: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """[CLS] words [SEP] padded to max_len, truncated as BERT truncates:
    (ids, mask), int64."""
    ids = np.full((len(texts_), max_len), PAD, np.int64)
    mask = np.zeros((len(texts_), max_len), np.int64)
    for i, t in enumerate(texts_):
        row = [CLS] + list(t[:max_len - 2]) + [SEP]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


def frames(seed: int, stream: int, index: int, n: int, hw: Sequence[int]
           ) -> np.ndarray:
    """``n`` seeded uint8 RGB frames (n, h, w, 3) of one video or image."""
    return rng(seed, stream, index).integers(
        0, 256, (n, hw[0], hw[1], 3), dtype=np.uint8)


class Gaps:
    """Gaps of the program's outputs (``got``) from the reference's
    (``want``), gathered over a sample."""

    def __init__(self):
        self.d, self.w = [], []

    def add(self, got, want) -> None:
        self.d.append((got.double() - want.double()).flatten().cpu())
        self.w.append(want.double().flatten().cpu())

    def rms(self) -> float:
        import torch
        return float(torch.cat(self.d).pow(2).mean().sqrt())

    def rel_rms(self) -> float:
        """The RMS gap over the reference's RMS."""
        import torch
        return self.rms() / float(torch.cat(self.w).pow(2).mean().sqrt())

    def stats(self) -> dict:
        import torch
        a = torch.cat(self.d).abs()
        return {"widest": float(a.max()), "rms": self.rms(),
                "rel_rms": self.rel_rms(), "median_abs": float(a.median())}


@contextlib.contextmanager
def tapped(module, name: str, sink):
    """While on, every call of ``module.<name>`` hands what it returns to
    ``sink`` (a device tensor, kept by reference) and returns it as it
    was: the port runs as it would."""
    fn = getattr(module, name)

    def call(*a, **kw):
        out = fn(*a, **kw)
        sink(out)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)
