"""The versioned meta-database store (``store``) and carrying a store
across (``state``)."""
from .store import (FieldSchema, Increment, VersionInfo, VersionView,
                    VersionedStore)

__all__ = ["FieldSchema", "Increment", "VersionInfo", "VersionView",
           "VersionedStore"]
