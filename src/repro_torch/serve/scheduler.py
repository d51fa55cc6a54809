"""Request scheduler: bucketed continuous batching over the ServeEngine.

Requests arrive asynchronously; the scheduler packs them into shape buckets
(seq padded to powers of two, so a few batch shapes cover every prompt),
dispatches full (or timed-out) buckets to the engine, and tracks
per-request latency. This is the piece a 1000-node serving fleet scales
horizontally; per-host state is just the queue.

Prompts are right-padded with ``pad_id`` to their bucket, and the prefill
reads the first generated token at the last (padded) position, as the JAX
package does: for a prompt shorter than its bucket that token comes from
a pad position. The port keeps this so that answers match.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np

from .engine import ServeEngine


@dataclasses.dataclass
class Request:
    rid: str
    tokens: np.ndarray
    t_submit: float = 0.0
    t_done: float = 0.0
    output: np.ndarray | None = None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Scheduler:
    def __init__(self, engine: ServeEngine, *, max_batch: int = 8,
                 max_wait_s: float = 0.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.queues: dict[int, list[Request]] = defaultdict(list)
        self.done: dict[str, Request] = {}

    def submit(self, rid: str, tokens: np.ndarray) -> None:
        req = Request(rid, np.asarray(tokens, np.int32), t_submit=time.time())
        self.queues[_bucket(len(req.tokens))].append(req)

    def _flush_bucket(self, bucket: int) -> None:
        reqs = self.queues[bucket][: self.max_batch]
        self.queues[bucket] = self.queues[bucket][self.max_batch:]
        if not reqs:
            return
        batch = np.full((len(reqs), bucket), self.engine.scfg.pad_id, np.int32)
        for i, r in enumerate(reqs):
            batch[i, : len(r.tokens)] = r.tokens
        outs = self.engine.generate(batch)
        now = time.time()
        for i, r in enumerate(reqs):
            r.output = outs[i]
            r.t_done = now
            self.done[r.rid] = r

    def run_until_drained(self) -> dict:
        while any(self.queues.values()):
            for bucket in sorted(self.queues):
                while self.queues[bucket]:
                    self._flush_bucket(bucket)
        lats = [r.t_done - r.t_submit for r in self.done.values()]
        return {"n_done": len(self.done),
                "p50_latency_s": float(np.percentile(lats, 50)) if lats else 0.0,
                "p99_latency_s": float(np.percentile(lats, 99)) if lats else 0.0}
