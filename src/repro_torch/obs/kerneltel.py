"""Kernel launch telemetry: wall time + bytes/FLOP roofline accounting.

The port's copy of ``repro.obs.kerneltel``. The store's host-facing
kernel sites (the fused superlog scan ``batched_select`` and the
``compact_rewrite`` log rewrite) wrap themselves in
``launch(name, nbytes=..., flops=...)``: the context manager times
launch-to-host-sync wall and aggregates per-kernel
``calls / wall_s / bytes / flops`` here, publishing mirrors into the
process-wide registry (``kernel.<name>.calls`` etc.).

Bytes/FLOP figures are analytic estimates of the traffic and arithmetic
(documented at each call site); ``snapshot()`` derives each kernel's
achieved GB/s and ``roofline_fraction`` against the card's constants in
``launch/roofline.py``. ``padded_nbytes`` carries any pad slack
separately from the logical traffic model. The wall is host time up to
the copy back, so it includes launch overhead and the host work between.

Overhead per launch is two ``perf_counter`` reads and one locked dict
update.
"""
from __future__ import annotations

import threading
import time

from ..launch.roofline import kernel_roofline

from .metrics import REGISTRY


class KernelTelemetry:
    """Per-kernel launch aggregation (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> [calls, wall_s, bytes, flops, padded_bytes]
        self._k: dict[str, list[float]] = {}

    def record(self, name: str, wall_s: float, nbytes: float,
               flops: float, padded_nbytes: float | None = None) -> None:
        padded = nbytes if padded_nbytes is None else padded_nbytes
        with self._lock:
            row = self._k.get(name)
            if row is None:
                row = self._k[name] = [0, 0.0, 0.0, 0.0, 0.0]
            row[0] += 1
            row[1] += wall_s
            row[2] += nbytes
            row[3] += flops
            row[4] += padded
        REGISTRY.counter(f"kernel.{name}.calls").inc()
        REGISTRY.counter(f"kernel.{name}.wall_s").inc(wall_s)
        REGISTRY.counter(f"kernel.{name}.bytes").inc(nbytes)
        REGISTRY.counter(f"kernel.{name}.flops").inc(flops)
        REGISTRY.counter(f"kernel.{name}.padded_bytes").inc(padded)

    def launch(self, name: str, *, nbytes: float, flops: float,
               padded_nbytes: float | None = None) -> "_Launch":
        """Context manager timing one launch-to-host-sync region.
        ``padded_nbytes`` (default: ``nbytes``) is the traffic including
        bucket/tile pad slack — the roofline numerator."""
        return _Launch(self, name, nbytes, flops, padded_nbytes)

    def snapshot(self) -> dict:
        """Per-kernel aggregates + derived roofline terms. ``bytes`` is the
        logical traffic model; ``padded_bytes`` (>= bytes) is what actually
        moved and feeds the roofline/GB/s terms."""
        with self._lock:
            rows = {n: list(r) for n, r in self._k.items()}
        out = {}
        for name, (calls, wall, nb, fl, pb) in rows.items():
            d = {"calls": int(calls), "wall_s": wall, "bytes": nb,
                 "flops": fl, "padded_bytes": pb,
                 "us_per_call": (wall / calls * 1e6) if calls else 0.0,
                 "gbytes_per_s": (pb / wall / 1e9) if wall else 0.0,
                 "logical_gbytes_per_s": (nb / wall / 1e9) if wall else 0.0}
            d["gflops_per_s"] = (fl / wall / 1e9) if wall else 0.0
            d.update(kernel_roofline(fl, pb, wall))
            out[name] = d
        return out

    def clear(self) -> None:
        with self._lock:
            self._k.clear()


class _Launch:
    __slots__ = ("_tel", "_name", "_nbytes", "_flops", "_padded", "_t0")

    def __init__(self, tel, name, nbytes, flops, padded_nbytes=None):
        self._tel, self._name = tel, name
        self._nbytes, self._flops = float(nbytes), float(flops)
        self._padded = None if padded_nbytes is None else float(padded_nbytes)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._tel.record(self._name, time.perf_counter() - self._t0,
                             self._nbytes, self._flops, self._padded)
        return False


#: the process-wide kernel telemetry the launch sites publish into.
KERNELS = KernelTelemetry()


def launch(name: str, *, nbytes: float, flops: float,
           padded_nbytes: float | None = None) -> _Launch:
    """``KERNELS.launch`` shorthand for the instrumented call sites."""
    return KERNELS.launch(name, nbytes=nbytes, flops=flops,
                          padded_nbytes=padded_nbytes)
