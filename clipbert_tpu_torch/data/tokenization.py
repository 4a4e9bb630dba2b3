# Copied from clipbert_tpu/data/tokenization.py: JAX-free host code, kept importable without jax.
"""Self-contained BERT WordPiece tokenizer.

The reference uses HF `BertTokenizerFast.from_pretrained(cfg.tokenizer_dir)`
(e.g. `src/pretrain/run_pretrain.py:75`,
`src/datasets/dataset_pretrain.py:123` batch_encode_plus with max_length
padding/truncation). This is a from-scratch implementation of the same
contract — standard BERT basic+wordpiece tokenization over a local
`vocab.txt` — so the data plane has no network or framework dependency.
Output matches HF conventions: [CLS] tokens [SEP], padded with [PAD],
`attention_mask`, and `special_tokens_mask` for the MLM masker.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Sequence

import numpy as np


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace/punctuation/CJK split + lowercasing + accent stripping."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = "".join(" " if _is_whitespace(c) else c
                       for c in text if not (_is_control(c) or ord(c) == 0
                                             or ord(c) == 0xFFFD))
        # pad CJK chars with spaces
        text = "".join(f" {c} " if _is_chinese_char(ord(c)) else c
                       for c in text)
        tokens = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for c in tok:
                if _is_punctuation(c):
                    tokens.extend(["".join(cur)] if cur else [])
                    tokens.append(c)
                    cur = []
                else:
                    cur.append(c)
            if cur:
                tokens.append("".join(cur))
        return tokens


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class BertTokenizer:
    """Greedy-longest-match WordPiece tokenizer over a BERT vocab.txt."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)
        for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
            assert tok in self.vocab, f"vocab missing {tok}"
        self.pad_token_id = self.vocab["[PAD]"]
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.mask_token_id = self.vocab["[MASK]"]

    SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    @classmethod
    def from_dir(cls, tokenizer_dir: str, **kw) -> "BertTokenizer":
        return cls(os.path.join(tokenizer_dir, "vocab.txt"), **kw)

    def __len__(self) -> int:
        return len(self.vocab)

    def _split_specials(self, text: str):
        """Yield (chunk, is_special): literal special tokens in the input
        are matched verbatim (case-sensitive, BEFORE lowercasing) and never
        split — the HF tokenizers' added-token behavior
        (tests/test_tokenizer_hf_parity.py pins it against both HF
        implementations)."""
        i = 0
        start = 0
        n = len(text)
        # every special starts with '[' — ordinary captions skip straight
        # to the tail yield without a per-character scan
        while True:
            i = text.find("[", i)
            if i == -1:
                break
            for sp in self.SPECIAL_TOKENS:
                if text.startswith(sp, i):
                    if start < i:
                        yield text[start:i], False
                    yield sp, True
                    i += len(sp)
                    start = i
                    break
            else:
                i += 1
        if start < n:
            yield text[start:], False

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk, is_special in self._split_specials(text):
            if is_special:
                out.append(chunk)
                continue
            for tok in self.basic.tokenize(chunk):
                out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.inv_vocab.get(i, "[UNK]") for i in ids]

    def encode(self, text: str, max_length: int = 20) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length total."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        ids = ids[:max_length - 2]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def batch_encode(self, texts: Sequence[str], max_length: int = 20
                     ) -> Dict[str, np.ndarray]:
        """Padded batch with HF-style masks (the collator contract,
        dataset_pretrain.py:123-131)."""
        B = len(texts)
        input_ids = np.full((B, max_length), self.pad_token_id, np.int32)
        attention_mask = np.zeros((B, max_length), np.int32)
        special = np.ones((B, max_length), np.int32)  # pads count as special
        for i, text in enumerate(texts):
            ids = self.encode(text, max_length)
            L = len(ids)
            input_ids[i, :L] = ids
            attention_mask[i, :L] = 1
            special[i, :L] = 0
            special[i, 0] = 1            # [CLS]
            special[i, L - 1] = 1        # [SEP]
        return {"input_ids": input_ids, "attention_mask": attention_mask,
                "special_tokens_mask": special}


def write_tiny_vocab(path: str, extra_tokens: Sequence[str] = ()) -> None:
    """Test helper: minimal valid vocab file."""
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    toks += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    toks += [str(d) for d in range(10)] + [".", ",", "?", "!"]
    toks += list(extra_tokens)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(dict.fromkeys(toks)) + "\n")
