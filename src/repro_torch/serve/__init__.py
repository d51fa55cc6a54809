"""Serving: the batched engine (prefill + ring-cache decode), sampling,
the bucketed request scheduler, the GeStore version-materialization
service (gestore_service.py) with its tiered store-memory manager, and
the multi-tenant front door (frontdoor.py) with admission control and
backpressure."""
from .engine import ServeConfig, ServeEngine
from .frontdoor import (AdmissionError, DeadlineExceeded, FrontDoor,
                        FrontDoorConfig, Overloaded, QueueFull)
from .gestore_service import GeStoreService, TieredStorePool, VersionRequest
from .scheduler import Scheduler

__all__ = [
    "AdmissionError", "DeadlineExceeded", "FrontDoor", "FrontDoorConfig",
    "GeStoreService", "Overloaded", "QueueFull", "Scheduler", "ServeConfig",
    "ServeEngine", "TieredStorePool", "VersionRequest",
]
