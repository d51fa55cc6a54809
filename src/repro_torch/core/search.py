"""Neural-BLAST: versioned embedding-similarity search with EXACT
incremental merge (the paper's BLAST workload adapted to the framework).

BLAST scores queries against every database sequence and normalizes by
database size (e-value). The embedding analogue: score = q . e_i / tau over
a versioned corpus; the normalizer Z(q) = logsumexp_i score_i plays the
e-value role — it depends on the WHOLE corpus, so incremental computation
must fix it at merge time.

GeStore trick (paper §III.A): partition corpus rows into segments; the
per-(query, segment) sufficient statistics are (top-k hits, logsumexp
partial). On a corpus update only segments containing changed rows are
re-embedded and re-scored; the merge overwrites those segments' statistics
and recombines: Z = logsumexp over segment partials, global top-k = top-k
over per-segment top-ks. This makes the merge EXACT — including under
DELETIONS (a deleted row only invalidates its own segment's statistics,
which is rescored by construction; the paper §III.A notes deletions are the
hard case for output merging).

The encoder is any fn from host tokens (N, L) to host embeddings (N, D)
f32 — e.g. the Meta-pipe encoder (``configs/metapipe.py`` through
``models.transformer.forward_train``, mean-pooled); incremental corpus
RE-EMBEDDING is where the 13x-style application win comes from (embedding
cost dominates, exactly like BLAST alignment cost).

Each segment's scores are one ``torch.matmul`` on the store's device (the
CUDA card, or the host for a ``device="cpu"`` store); the per-segment
top-k and log-sum-exp bookkeeping stays in numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .store import VersionedStore, KIND_DELETED

Encoder = Callable[[np.ndarray], np.ndarray]  # (N, L) int tokens -> (N, D) f32

NEG = -np.inf


@dataclasses.dataclass
class SearchResult:
    """Mergeable per-(query, segment) sufficient statistics."""
    query_ids: list[bytes]
    k: int
    seg_topk_idx: np.ndarray    # (Q, S, k) corpus rows (-1 empty)
    seg_topk_score: np.ndarray  # (Q, S, k)
    seg_lse: np.ndarray         # (Q, S)
    ts: int

    @property
    def z(self) -> np.ndarray:  # (Q,) full-corpus normalizer
        return _lse(self.seg_lse, axis=1)

    @property
    def topk_idx(self) -> np.ndarray:
        idx, _ = self._global_topk()
        return idx

    @property
    def topk_score(self) -> np.ndarray:
        _, sc = self._global_topk()
        return sc

    def _global_topk(self):
        q, s, k = self.seg_topk_idx.shape
        flat_i = self.seg_topk_idx.reshape(q, s * k)
        flat_s = self.seg_topk_score.reshape(q, s * k)
        order = np.argsort(-flat_s, axis=1, kind="stable")[:, : self.k]
        return (np.take_along_axis(flat_i, order, 1),
                np.take_along_axis(flat_s, order, 1))

    def evalue(self) -> np.ndarray:
        """(Q, k) normalized significance: p = exp(score - Z)."""
        return np.exp(self.topk_score - self.z[:, None])


def _lse(x: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return (m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))).squeeze(axis)


def _score_block(q_emb: torch.Tensor, c_emb: np.ndarray,
                 tau: float) -> np.ndarray:
    """(Q, n) f32 scores q . c / tau of one segment, on q's device."""
    c = torch.as_tensor(c_emb, dtype=torch.float32, device=q_emb.device)
    return (torch.matmul(q_emb, c.T) / tau).cpu().numpy()


class EmbeddingSearchDB:
    """Segmented, versioned embedding index over a VersionedStore field."""

    def __init__(self, store: VersionedStore, encoder: Encoder, *,
                 token_field: str = "sequence", seg_size: int = 64,
                 tau: float = 4.0):
        self.store = store
        self.encoder = encoder
        self.token_field = token_field
        self.seg_size = seg_size
        self.tau = tau
        self._emb: np.ndarray | None = None
        self._emb_ts: int = -1
        self._embedded_rows = np.zeros(0, bool)
        self.n_embedded_total = 0                # work counter (bench metric)

    # -- corpus embedding (full / incremental) -------------------------------
    def refresh(self, ts: int, *, t_last: int | None = None) -> int:
        """Embed the corpus at version ts; with t_last, only rows whose
        token field changed in (t_last, ts]. Returns rows embedded."""
        n = self.store.n_rows
        if t_last is None or self._emb is None:
            view = self.store.get_version(ts, fields=[self.token_field])
            emb = np.asarray(self.encoder(view.values[self.token_field]))
            d = emb.shape[1] if len(emb) else 1
            self._emb = np.zeros((n, d), np.float32)
            self._embedded_rows = np.zeros(n, bool)
            if len(view):
                self._emb[view.row_idx] = emb
                self._embedded_rows[view.row_idx] = True
            self._emb_ts = ts
            self.n_embedded_total += len(view)
            return len(view)
        inc = self.store.get_increment(t_last, ts,
                                       significant_fields=[self.token_field],
                                       fields=[self.token_field])
        live = inc.kind != KIND_DELETED
        rows = inc.row_idx[live]
        if n > len(self._embedded_rows):          # corpus grew
            grown = np.zeros((n, self._emb.shape[1]), np.float32)
            grown[: len(self._emb)] = self._emb
            self._emb = grown
            g = np.zeros(n, bool)
            g[: len(self._embedded_rows)] = self._embedded_rows
            self._embedded_rows = g
        if len(rows):
            emb = np.asarray(self.encoder(inc.values[self.token_field][live]))
            self._emb[rows] = emb
            self._embedded_rows[rows] = True
        dead = inc.row_idx[inc.kind == KIND_DELETED]
        self._embedded_rows[dead] = False
        self._emb_ts = ts
        self.n_embedded_total += int(live.sum())
        return int(live.sum())

    # -- segments -------------------------------------------------------------
    def n_segments(self) -> int:
        return max(1, -(-self.store.n_rows // self.seg_size))

    def changed_segments(self, t0: int, t1: int) -> np.ndarray:
        inc = self.store.get_increment(t0, t1,
                                       significant_fields=[self.token_field],
                                       fields=[])
        return np.unique(inc.row_idx // self.seg_size)

    # -- query ------------------------------------------------------------------
    def query(self, query_ids: list[bytes], q_tokens: np.ndarray, *, ts: int,
              k: int = 10, segments: np.ndarray | None = None,
              prev: SearchResult | None = None) -> SearchResult:
        """Full search (segments=None) or incremental: score only `segments`
        and merge onto `prev`'s per-segment statistics (exact)."""
        assert ts == self._emb_ts, "call refresh(ts) first"
        q_emb = torch.as_tensor(np.asarray(self.encoder(q_tokens)),
                                dtype=torch.float32, device=self.store.device)
        alive = self.store.exists_at(ts) & self._embedded_rows
        n_seg = self.n_segments()
        todo = np.arange(n_seg) if segments is None else np.asarray(segments)
        nq = len(query_ids)

        if prev is None:
            seg_idx = np.full((nq, n_seg, k), -1, np.int64)
            seg_score = np.full((nq, n_seg, k), NEG, np.float32)
            seg_lse = np.full((nq, n_seg), NEG, np.float32)
        else:
            assert prev.k == k, "k must match prev result for merging"
            s_prev = prev.seg_lse.shape[1]
            seg_idx = np.full((nq, n_seg, k), -1, np.int64)
            seg_score = np.full((nq, n_seg, k), NEG, np.float32)
            seg_lse = np.full((nq, n_seg), NEG, np.float32)
            seg_idx[:, :s_prev] = prev.seg_topk_idx
            seg_score[:, :s_prev] = prev.seg_topk_score
            seg_lse[:, :s_prev] = prev.seg_lse

        for seg in todo:
            seg = int(seg)
            lo = seg * self.seg_size
            hi = min(self.store.n_rows, lo + self.seg_size)
            rows = np.arange(lo, hi)[alive[lo:hi]]
            if len(rows) == 0:
                seg_lse[:, seg] = NEG
                seg_idx[:, seg] = -1
                seg_score[:, seg] = NEG
                continue
            s = _score_block(q_emb, self._emb[rows], self.tau)
            seg_lse[:, seg] = _lse(s, axis=1)
            kk = min(k, s.shape[1])
            part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
            psc = np.take_along_axis(s, part, 1)
            order = np.argsort(-psc, axis=1, kind="stable")
            seg_idx[:, seg] = -1
            seg_score[:, seg] = NEG
            seg_idx[:, seg, :kk] = rows[np.take_along_axis(part, order, 1)]
            seg_score[:, seg, :kk] = np.take_along_axis(psc, order, 1)

        return SearchResult(query_ids, k, seg_idx, seg_score, seg_lse, ts)

    # -- the end-to-end incremental path (GeStore generate->tool->merge) ------
    def incremental_query(self, prev: SearchResult, query_ids, q_tokens, *,
                          t_last: int, ts: int, k: int | None = None) -> SearchResult:
        k = prev.k if k is None else k
        n_embedded = self.refresh(ts, t_last=t_last)
        segs = self.changed_segments(t_last, ts)
        res = self.query(query_ids, q_tokens, ts=ts, k=k, segments=segs,
                         prev=prev)
        res.n_embedded = n_embedded  # type: ignore[attr-defined]
        return res
