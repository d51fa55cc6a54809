"""Straggler detection + mitigation policy.

At pod scale, slow hosts (thermal throttling, failing memory, network
flaps) stretch every synchronous step. The monitor keeps a window of
per-host step times; a host whose recent mean exceeds the fleet's median
by `sigma_threshold` robust sigmas (median absolute deviation) for
`patience` consecutive evaluations is flagged. Policy hook: flag ->
CHECKPOINT_AND_REPLACE, so the trainer snapshots (ft/checkpoint.py,
asynchronously) and the scheduler can drain and replace the host.

Host step times come from the trainer's per-step wall clock; in tests they
are synthetic. numpy only: the JAX package's module, copied.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import numpy as np

OK, WARN, CHECKPOINT_AND_REPLACE = "ok", "warn", "checkpoint_and_replace"


@dataclasses.dataclass
class StragglerConfig:
    window: int = 16
    sigma_threshold: float = 3.0
    patience: int = 3
    min_steps: int = 8


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.cfg.window))
        self.strikes: dict[str, int] = defaultdict(int)

    def record(self, host: str, step_time: float) -> None:
        self.times[host].append(step_time)

    def evaluate(self) -> dict[str, str]:
        """Per-host verdicts. Robust center/scale (median + MAD): a straggler
        inflates the plain mean/std enough to hide itself behind a k-sigma
        gate when the fleet sample is small."""
        means = {h: float(np.mean(t)) for h, t in self.times.items()
                 if len(t) >= self.cfg.min_steps}
        if len(means) < 2:
            return {h: OK for h in self.times}
        vals = np.asarray(list(means.values()))
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med))) * 1.4826  # ~sigma
        out = {}
        for h, m in means.items():
            slow = m > med + self.cfg.sigma_threshold * max(mad, 1e-6) and \
                m > 1.05 * med
            if slow:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.cfg.patience:
                out[h] = CHECKPOINT_AND_REPLACE
            elif self.strikes[h] > 0:
                out[h] = WARN
            else:
                out[h] = OK
        return out

    def worst(self) -> tuple[str, float] | None:
        means = {h: float(np.mean(t)) for h, t in self.times.items() if t}
        if not means:
            return None
        h = max(means, key=means.get)
        return h, means[h]
