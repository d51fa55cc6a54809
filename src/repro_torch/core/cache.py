"""Materialized meta-database cache (paper §III.E).

GeStore caches generated meta-database files in HDFS because many workflows
share them; the *filename* uniquely identifies content: file id, time range,
entry-selection regex, plugin params, and optionally run/task ids. We keep
that property: the descriptor is a canonical string, the on-disk name embeds
a digest of it, and the `files` system table maps descriptor -> path.
Unbounded by default (paper: "GeStore does not limit the cache size; the
oldest files can be deleted by e.g. a cron job") — `evict()` is that cron
job.

The port's copy of ``repro.core.cache``: the same descriptors and
cache paths.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable

from .tables import SystemTables


def descriptor(file_id: str, t0: int, t1: int, *, filter_expr: str = "",
               plugin: str = "", params: dict | None = None,
               run_id: str = "", task_id: str = "") -> str:
    parts = [file_id, str(t0), str(t1), filter_expr, plugin]
    for k in sorted(params or {}):
        parts.append(f"{k}={params[k]}")
    if run_id:
        parts.append(f"run={run_id}")
    if task_id:
        parts.append(f"task={task_id}")
    return "|".join(parts)


class VersionCache:
    def __init__(self, root: str, tables: SystemTables | None = None, *,
                 max_bytes: int | None = None):
        """Args:
          root: cache directory.
          tables: `files` system table (descriptor -> path index).
          max_bytes: optional byte budget — every ``put`` runs the LRU
            ``evict`` down to it, so serving hosts get a bounded cache
            instead of the paper's unbounded-plus-cron-job model. None
            (default) preserves the paper-faithful unbounded behavior.
            A budget smaller than a single generated file still admits
            the file being written (``put`` returns a live path); it is
            evicted by the next put.
        """
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.tables = tables or SystemTables()
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0

    def _path_for(self, desc: str, suffix: str) -> str:
        digest = hashlib.sha256(desc.encode()).hexdigest()[:24]
        safe = "".join(c if c.isalnum() or c in "._-=" else "_" for c in desc)[:80]
        return os.path.join(self.root, f"{safe}.{digest}{suffix}")

    def get(self, desc: str) -> str | None:
        row = self.tables.lookup_file(desc)
        if row is not None and row.path and os.path.exists(row.path):
            self.hits += 1
            return row.path
        self.misses += 1
        return None

    def put(self, desc: str, writer: Callable[[str], None], *, plugin: str = "",
            suffix: str = ".bin", in_store: bool = True) -> str:
        """Generate-or-return: writer(path) materializes the file on miss."""
        path = self.get(desc)
        if path is not None:
            self.misses -= 1  # get() above counted a hit
            return path
        path = self._path_for(desc, suffix)
        tmp = path + ".tmp"
        writer(tmp)
        os.replace(tmp, path)
        self.tables.record_file(desc, path, plugin, in_store,
                                nbytes=os.path.getsize(path))
        if self.max_bytes is not None:
            self.evict(self.max_bytes, protect=desc)
        return path

    def evict(self, max_bytes: int, *, protect: str | None = None) -> int:
        """Drop least-recently-used generated files until total <= max_bytes.

        Store segment manifests (plugin ``store-segment``, recorded by
        ``GeStore.flush``) are never candidates: generated files are
        regenerable from the store, but the segments ARE the store —
        evicting them would destroy data, not cache. ``protect`` exempts
        one descriptor (the file a ``put`` just returned a live path to).
        """
        rows = sorted((r for r in self.tables.files.values()
                       if r.path and r.plugin != "store-segment"),
                      key=lambda r: r.last_used)
        total = sum(r.bytes for r in rows)
        n = 0
        for r in rows:
            if total <= max_bytes:
                break
            if r.file_id == protect:
                continue
            if os.path.exists(r.path):
                os.remove(r.path)
            total -= r.bytes
            self.tables.drop_file(r.file_id)
            n += 1
        return n
