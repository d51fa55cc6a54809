"""Deterministic sharded batch pipeline.

Packs a token stream into (global_batch, seq_len+1) examples, shuffles with
a seeded permutation per epoch, and yields per-host slices (each host feeds
its local devices; `host_id`/`n_hosts` are the process's rank and the
process count of a real cluster). Determinism = f(seed, corpus version ts,
step), so elastic restarts resume exactly. numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


class TokenPipeline:
    def __init__(self, tokens: np.ndarray, cfg: DataConfig):
        self.cfg = cfg
        ex_len = cfg.seq_len + 1
        n_ex = len(tokens) // ex_len
        assert n_ex >= 1, "corpus smaller than one example"
        self.examples = tokens[: n_ex * ex_len].reshape(n_ex, ex_len)

    def n_steps_per_epoch(self) -> int:
        return max(len(self.examples) // self.cfg.global_batch, 1)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for global step (any host can compute it)."""
        cfg = self.cfg
        spe = self.n_steps_per_epoch()
        epoch, within = divmod(step, spe)
        rng = np.random.default_rng(cfg.seed + epoch)
        perm = rng.permutation(len(self.examples))
        idx = perm[within * cfg.global_batch:(within + 1) * cfg.global_batch]
        if len(idx) < cfg.global_batch:  # wrap the tail
            idx = np.concatenate([idx, perm[: cfg.global_batch - len(idx)]])
        ex = self.examples[idx]
        # host slice
        per_host = cfg.global_batch // cfg.n_hosts
        lo = cfg.host_id * per_host
        ex = ex[lo: lo + per_host] if cfg.n_hosts > 1 else ex
        return {"tokens": ex[:, :-1].astype(np.int32),
                "labels": ex[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
