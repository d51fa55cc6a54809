"""Serving: the batched engine (prefill + ring-cache decode), sampling,
and the bucketed request scheduler."""
from .engine import ServeConfig, ServeEngine
from .scheduler import Scheduler

__all__ = ["Scheduler", "ServeConfig", "ServeEngine"]
