"""Versioned training corpus on the GeStore core (DESIGN.md §2).

Documents live in a VersionedStore (text chunk rows + token rows); a corpus
release update triggers INCREMENTAL re-tokenization: only documents whose
text changed in (t_last, t] are re-encoded — the paper's incremental update
applied to the data pipeline. Training jobs pin a corpus version ts, giving
exact data reproducibility across reruns ("gold standard" requirement).

``device`` (None: the CUDA card, raising without one; ``"cpu"``: the
host) is where the corpus store runs, and where ``incremental_release``
fingerprints the release's text rows against the stored head.
"""
from __future__ import annotations

import numpy as np

from ..core.store import FieldSchema, VersionedStore
from ..kernels import ops as kops
from .tokenizer import ByteTokenizer

TEXT_W = 1024
TOK_W = 1024


class VersionedCorpus:
    def __init__(self, name: str = "corpus",
                 tokenizer: ByteTokenizer | None = None, *, device=None):
        self.tokenizer = tokenizer or ByteTokenizer()
        self.store = VersionedStore(name, [
            FieldSchema("text", TEXT_W, "int8"),
            FieldSchema("tokens", TOK_W, "int32"),
            FieldSchema("n_tokens", 1, "int32"),
        ], device=device)
        self.tokens_encoded_total = 0   # work counter (bench metric)

    def _doc_rows(self, docs: dict[str, str]):
        keys, texts, toks, lens = [], [], [], []
        for k, text in docs.items():
            b = text.encode()[:TEXT_W]
            trow = np.zeros(TEXT_W, np.int8)
            trow[: len(b)] = np.frombuffer(b, np.uint8).astype(np.int8)
            enc = self.tokenizer.encode(text)[:TOK_W]
            krow = np.zeros(TOK_W, np.int32)
            krow[: len(enc)] = enc
            keys.append(k.encode())
            texts.append(trow)
            toks.append(enc := krow)
            lens.append(np.asarray([min(len(self.tokenizer.encode(text)), TOK_W)],
                                   np.int32))
        return keys, {"text": np.stack(texts), "tokens": np.stack(toks),
                      "n_tokens": np.stack(lens)}

    def add_release(self, ts: int, docs: dict[str, str], *,
                    full_release: bool = True):
        """Ingest a corpus release; tokenization happens here (the 'tool')."""
        keys, table = self._doc_rows(docs)
        self.tokens_encoded_total += len(docs)
        return self.store.update(ts, keys, table, full_release=full_release)

    def incremental_release(self, t_last: int, ts: int, docs: dict[str, str]):
        """Only re-tokenize docs whose TEXT changed vs version t_last (change
        detection on the raw field, tokenization only for the increment)."""
        keys = [k.encode() for k in docs]
        texts = []
        for k, text in docs.items():
            b = text.encode()[:TEXT_W]
            row = np.zeros(TEXT_W, np.int8)
            row[: len(b)] = np.frombuffer(b, np.uint8).astype(np.int8)
            texts.append(row)
        texts = np.stack(texts)
        # find which docs actually changed (fingerprint against head)
        fp = kops.fingerprint_rows(texts, self.store.device)
        self.store.rebuild_heads(["text"])  # stale after a lazy load
        col = self.store.fields["text"]
        changed_keys = {}
        for i, k in enumerate(keys):
            row = self.store.key_to_row.get(k, -1)
            if row < 0 or not col.head_has[row] or \
                    not (fp[i] == col.head_fp[row]).all():
                changed_keys[k.decode()] = docs[k.decode()]
        ck, table = self._doc_rows(changed_keys) if changed_keys else \
            ([], {"text": np.zeros((0, TEXT_W), np.int8),
                  "tokens": np.zeros((0, TOK_W), np.int32),
                  "n_tokens": np.zeros((0, 1), np.int32)})
        self.tokens_encoded_total += len(changed_keys)
        # patch update carrying only changed docs; the full release key set
        # drives deletion tombstones (present_keys)
        return self.store.update(ts, ck, table, full_release=False,
                                 present_keys=keys)

    def token_stream(self, ts: int) -> np.ndarray:
        """Concatenated token ids of corpus version ts (packing input)."""
        view = self.store.get_version(ts, fields=["tokens", "n_tokens"])
        parts = [row[:n[0]] for row, n in
                 zip(view.values["tokens"], view.values["n_tokens"])]
        return (np.concatenate(parts) if parts else np.zeros(0, np.int32))
