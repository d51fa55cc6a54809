"""Observability the store calls: the metrics registry (``metrics``),
trace spans and the stage timer (``trace``), the flight recorder of
recent events (``recorder``), per-kernel launch telemetry with roofline
fractions (``kerneltel``), and the structured logger the launchers
configure (``log``)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY
from .recorder import RECORDER, FlightRecorder, install_excepthook
from .trace import (Span, StageTimer, current_span, current_trace_id,
                    new_trace_id, span)

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
    "RECORDER", "REGISTRY", "Span", "StageTimer", "current_span",
    "current_trace_id", "install_excepthook", "new_trace_id", "span",
]
