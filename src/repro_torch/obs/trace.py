"""Trace spans and the per-stage timer the store calls.

The port's copy of ``repro.obs.trace``. ``StageTimer`` keeps the additive
``trace[stage] += seconds`` contract of ``get_versions(trace=...)``, and
folds each stage's seconds into the enclosing span and into the registry
histogram ``stage.<name>``. ``span(name, ...)`` pushes onto the calling
thread's stack (nesting gives ``parent`` links) and on exit records its
duration into the ``span.<name>`` histogram; the flight-recorder event the
JAX package also writes waits until the recorder is ported.
"""
from __future__ import annotations

import threading
import time

from .metrics import REGISTRY

_id_lock = threading.Lock()
_id_next = 0

_tls = threading.local()


def new_trace_id(prefix: str = "req") -> str:
    """Mint a process-unique id, e.g. ``req-000017`` / ``wave-000018``."""
    global _id_next
    with _id_lock:
        _id_next += 1
        n = _id_next
    return f"{prefix}-{n:06d}"


class Span:
    """One live span on a thread's stack (use the ``span()`` context
    manager; this class is the handle it yields)."""

    __slots__ = ("name", "trace_id", "parent_id", "fields", "stages",
                 "duration_s")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 fields: dict):
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.fields = fields
        self.stages: dict[str, float] = {}
        self.duration_s = 0.0

    def add_stage(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds


def current_span() -> Span | None:
    """The innermost active span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class span:
    """Context manager opening a span on the calling thread.

    Args:
      name: span name (becomes the ``span.<name>`` histogram).
      trace_id: propagate an existing id; None inherits the enclosing
        span's id, or mints a fresh one at the root.
      **fields: structured payload kept on the span.
    """

    __slots__ = ("_name", "_trace_id", "_fields", "_span", "_t0")

    def __init__(self, name: str, *, trace_id: str | None = None, **fields):
        self._name = name
        self._trace_id = trace_id
        self._fields = fields

    def __enter__(self) -> Span:
        parent = current_span()
        tid = self._trace_id
        if tid is None:
            tid = parent.trace_id if parent is not None else new_trace_id()
        s = Span(self._name, tid,
                 parent.trace_id if parent is not None else None,
                 self._fields)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(s)
        self._span = s
        self._t0 = time.perf_counter()
        return s

    def __exit__(self, exc_type, exc, tb):
        s = self._span
        s.duration_s = time.perf_counter() - self._t0
        _tls.stack.pop()
        REGISTRY.histogram(f"span.{s.name}").record(s.duration_s)
        return False


class StageTimer:
    """Accumulate wall seconds into ``trace[stage]`` (no-op when trace is
    None). Additive: one trace dict can span a whole wave. Each exit also
    feeds the enclosing span (if any) and the ``stage.<name>`` histogram.
    Host wall time: a stage that ends in a device-to-host copy includes
    the device work it waited for."""

    __slots__ = ("_trace", "_stage", "_t0")

    def __init__(self, trace: dict | None, stage: str):
        self._trace, self._stage = trace, stage

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._trace is not None:
            self._trace[self._stage] = (self._trace.get(self._stage, 0.0)
                                        + dt)
        s = current_span()
        if s is not None:
            s.add_stage(self._stage, dt)
        REGISTRY.histogram(f"stage.{self._stage}").record(dt)
        return False
