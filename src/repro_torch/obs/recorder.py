"""Flight recorder: a bounded ring of recent structured events.

The port's copy of ``repro.obs.recorder``.

When a wave fails three layers down (a segment read raising
``CorruptSegmentError`` inside a batched scan inside a multi-tenant
wave), the stack trace alone does not say *which* request, store, and
spill history led there. The recorder keeps the last ``cap`` structured
events — admission rejections, wave/mutation failures, pool
spill/reload churn, segment read errors, completed spans — each stamped
with a monotonic sequence number and the active trace id, so the dump
reconstructs the failure's context after the fact.

Dump on demand with ``RECORDER.dump()`` / ``dump_json(path)``, or set
``GESTORE_FLIGHT_DUMP=<path>`` to install an excepthook that writes the
dump when the process dies on an unhandled exception.

Events are plain dicts ``{"seq", "t", "kind", ...fields}`` (``t`` is
``time.time()``); the ring drops oldest-first and counts drops, so a
dump always says how much history it lost.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

from .trace import current_trace_id

DEFAULT_CAP = 512


class FlightRecorder:
    """Thread-safe bounded event ring (see module docstring)."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self._lock = threading.Lock()
        self._cap = max(int(cap), 1)
        self._ring: deque[dict] = deque(maxlen=self._cap)
        self._seq = 0
        self._dropped = 0

    @property
    def cap(self) -> int:
        return self._cap

    def record(self, kind: str, **fields) -> None:
        """Append one event; the active trace id is attached automatically
        unless the caller passed an explicit ``trace`` field."""
        if "trace" not in fields:
            tid = current_trace_id()
            if tid is not None:
                fields["trace"] = tid
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._cap:
                self._dropped += 1
            self._ring.append({"seq": self._seq, "t": time.time(),
                               "kind": kind, **fields})

    def events(self, kind: str | None = None) -> list[dict]:
        """Snapshot of the ring, oldest first (optionally one kind)."""
        with self._lock:
            evs = list(self._ring)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def dump(self) -> dict:
        """The full dump payload: events plus loss accounting."""
        with self._lock:
            return {"cap": self._cap, "recorded": self._seq,
                    "dropped": self._dropped, "events": list(self._ring)}

    def dump_json(self, path: str) -> str:
        """Write ``dump()`` as JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=2, default=str)
        return path

    def clear(self) -> None:
        """Drop every event and reset counters (test isolation)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0


def _cap_from_env() -> int:
    try:
        return int(os.environ.get("GESTORE_FLIGHT_CAP", DEFAULT_CAP))
    except ValueError:
        return DEFAULT_CAP


#: the process-wide recorder every layer publishes into.
RECORDER = FlightRecorder(_cap_from_env())


def install_excepthook(path: str | None = None) -> None:
    """Chain an excepthook that dumps the recorder to ``path`` (default
    ``GESTORE_FLIGHT_DUMP``) before the previous hook runs."""
    dest = path or os.environ.get("GESTORE_FLIGHT_DUMP")
    if not dest:
        return
    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        RECORDER.record("unhandled_exception", error=repr(exc))
        try:
            RECORDER.dump_json(dest)
        except OSError:
            pass
        prev(exc_type, exc, tb)

    sys.excepthook = _hook


if os.environ.get("GESTORE_FLIGHT_DUMP"):
    install_excepthook()
