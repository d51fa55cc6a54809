"""Observability the store calls: the metrics registry (``metrics``),
trace spans and the stage timer (``trace``), the flight recorder of
recent events (``recorder``), per-kernel launch telemetry with roofline
fractions (``kerneltel``), and the structured logger the launchers
configure (``log``). ``snapshot_all`` combines the first, the third and
the fourth, as the JAX package's ``repro.obs.snapshot_all`` does."""
from .log import configure as configure_logging, get_logger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY
from .recorder import RECORDER, FlightRecorder, install_excepthook
from .trace import (Span, StageTimer, current_span, current_trace_id,
                    new_trace_id, span)

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "Histogram", "MetricsRegistry",
    "RECORDER", "REGISTRY", "Span", "StageTimer", "configure_logging",
    "current_span", "current_trace_id", "get_logger", "install_excepthook",
    "new_trace_id", "snapshot_all", "span",
]


def snapshot_all() -> dict:
    """One combined observability snapshot: global registry metrics,
    per-kernel roofline telemetry, and the flight-recorder dump."""
    from .kerneltel import KERNELS
    return {"metrics": REGISTRY.snapshot(), "kernels": KERNELS.snapshot(),
            "flight_recorder": RECORDER.dump()}
