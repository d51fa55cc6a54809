"""The versioned meta-database store (``store``), its segmented on-disk
layout (``segments``), carrying a store across in memory (``state``), and
the sharded store (``shard``) with its shard->device placement
(``placement``)."""
from .shard import ShardedReleaseSession, ShardedStore, open_any_store
from .store import (FieldSchema, Increment, VersionInfo, VersionView,
                    VersionedStore)

__all__ = ["FieldSchema", "Increment", "ShardedReleaseSession",
           "ShardedStore", "VersionInfo", "VersionView", "VersionedStore",
           "open_any_store"]
