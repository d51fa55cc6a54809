"""Byte-level tokenizer with a versioned vocabulary remap.

Deliberately simple (no external deps): tokens are bytes offset by the
number of special tokens. The vocab *version* matters to the GeStore story:
a tokenizer/vocab update is a meta-database update, and the versioned
dataset re-tokenizes only changed documents (data/versioned_dataset.py).
"""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int = 259):
        assert vocab_size >= 256 + N_SPECIAL
        self.vocab_size = vocab_size

    def encode(self, text: str, *, bos: bool = True, eos: bool = True) -> np.ndarray:
        b = np.frombuffer(text.encode("utf-8", "replace"), np.uint8)
        toks = b.astype(np.int32) + N_SPECIAL
        parts = []
        if bos:
            parts.append([BOS])
        parts.append(toks)
        if eos:
            parts.append([EOS])
        return np.concatenate([np.asarray(p, np.int32) for p in parts])

    def decode(self, toks) -> str:
        toks = np.asarray(toks)
        body = toks[(toks >= N_SPECIAL)] - N_SPECIAL
        return body.astype(np.uint8).tobytes().decode("utf-8", "replace")
