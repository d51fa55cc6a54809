"""The versioned meta-database store (``store``), its segmented on-disk
layout (``segments``), and carrying a store across in memory (``state``)."""
from .store import (FieldSchema, Increment, VersionInfo, VersionView,
                    VersionedStore)

__all__ = ["FieldSchema", "Increment", "VersionInfo", "VersionView",
           "VersionedStore"]
