"""GeStore core: the paper's contribution as a composable library.

Layers: VersionedStore (MVCC columnar storage, ``store``; its segmented
on-disk layout, ``segments``; carried across in memory, ``state``; spread
over shards, ``shard``, with its shard->device placement, ``placement``)
-> change detection (``change``) -> increment engine (``increment``:
``GeStore``, generate/merge around unmodified tools) -> plugins/parsers
-> cache + system tables; the streaming release ingest (``ingest``); and
versioned embedding search with an exact incremental merge (``search``).
"""
from .store import (FieldSchema, Increment, VersionedStore, VersionInfo,
                    VersionView, KIND_DELETED, KIND_NEW, KIND_UPDATED, TS_MAX)
from .shard import ShardedReleaseSession, ShardedStore, open_any_store
from .tables import SystemTables
from .cache import VersionCache, descriptor
from .plugins import (FileGenerator, FileParser, OutputMerger, PluginRegistry,
                      REGISTRY, ToolPlugin)
from .mergers import AppendMerger, BlastEvalueMerger
from .increment import GeneratedInput, GeStore
from .change import SignificanceProfile, classify
from .search import EmbeddingSearchDB, SearchResult

__all__ = [
    "FieldSchema", "Increment", "VersionedStore", "VersionInfo", "VersionView",
    "KIND_DELETED", "KIND_NEW", "KIND_UPDATED", "TS_MAX",
    "ShardedReleaseSession", "ShardedStore", "open_any_store", "SystemTables",
    "VersionCache", "descriptor", "FileGenerator", "FileParser", "OutputMerger",
    "PluginRegistry", "REGISTRY", "ToolPlugin", "AppendMerger",
    "BlastEvalueMerger", "GeneratedInput", "GeStore", "SignificanceProfile",
    "classify", "EmbeddingSearchDB", "SearchResult",
]
