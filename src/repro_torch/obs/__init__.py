"""Observability the store calls: the metrics registry (``metrics``),
trace spans and the stage timer (``trace``), and per-kernel launch
telemetry with roofline fractions (``kerneltel``). The structured logger
and the flight recorder wait for the slices that use them."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY
from .trace import Span, StageTimer, current_span, new_trace_id, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "Span",
    "StageTimer", "current_span", "new_trace_id", "span",
]
