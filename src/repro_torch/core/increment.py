"""Incremental-compute engine (paper §III.A + §III.G).

The workflow-manager-facing interface is two calls (paper: `generateFiles` /
`mergeFiles`): before running a tool, generate its input/meta-database files
(full version or increment, cache-aware); after running it, merge the
partial output into the previous result. The tool itself is UNMODIFIED — it
just reads and writes files.

`generate_files_batch` is the multi-version entry point: requests are
grouped per store and materialized through the store's fused-superlog
batched scan (store.get_versions / get_increments), so N concurrent
version materializations cost one scan per store-group instead of N x F
kernel launches. `generate_files` is its single-request wrapper.

The port's copy of ``repro.core.increment``: the same files, cache paths
and store directories, with every store of a ``GeStore`` on its
``device`` (the CUDA card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Callable, Mapping, Sequence

import numpy as np

from ..kernels._compat import resolve_device
from .cache import VersionCache, descriptor
from .plugins import PluginRegistry, ToolPlugin
from .shard import (SHARD_MANIFEST_NAME, ShardedStore, is_sharded_dir,
                    open_any_store)
from .store import (FieldSchema, Increment, VersionedStore, KIND_DELETED,
                    KIND_NEW, KIND_UPDATED)
from .tables import SystemTables


@dataclasses.dataclass
class GeneratedInput:
    path: str
    mode: str                 # "full" | "increment" | "cached"
    t0: int
    t1: int
    n_entries: int
    context: dict             # merge context (db sizes, deleted/updated keys)


def _live_filtered(inc: Increment, key_filter: str | None) -> Increment:
    """Drop tombstoned entries (they are merge context, not file content),
    then apply the entry-selection regex."""
    live = inc.kind != KIND_DELETED
    sub = Increment(inc.t0, inc.t1,
                    [k for k, m in zip(inc.keys, live) if m],
                    inc.row_idx[live], inc.kind[live],
                    {f: v[live] for f, v in inc.values.items()})
    if key_filter is not None:
        pat = re.compile(key_filter.encode())
        m = [bool(pat.search(k)) for k in sub.keys]
        m = np.asarray(m, bool) if m else np.zeros(0, bool)
        sub = Increment(sub.t0, sub.t1,
                        [k for k, mm in zip(sub.keys, m) if mm],
                        sub.row_idx[m], sub.kind[m],
                        {f: v[m] for f, v in sub.values.items()})
    return sub


class GeStore:
    """Facade owning stores + cache + system tables + plugin registry.

    Stores persist under ``<root>/stores/<name>`` in the segmented layout
    (core/segments.py): ``flush()`` saves them incrementally, and the
    constructor reopens every persisted store with a lazy load — so a
    GeStore over hundreds of releases starts in O(manifests), not O(cells).
    Every store it creates or reopens runs on its ``device``.
    """

    def __init__(self, root: str, registry: PluginRegistry, *,
                 device=None, autoload: bool = True,
                 cache_max_bytes: int | None = None):
        """Args:
          root: GeStore home (system tables, cache, persisted stores).
          registry: parser/tool plugins.
          device: where every store's scans, gathers and fingerprints
            run: None is the CUDA card (and raises without one);
            ``"cpu"`` runs the kernels' plain torch versions on the host.
          autoload: reopen stores previously persisted by ``flush()``
            (lazy — segment files are read only when queries need them).
          cache_max_bytes: byte budget for the generated-file cache —
            every ``cache.put`` LRU-evicts down to it (None = unbounded,
            the paper's cron-job retention model).
        """
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.tables = SystemTables(os.path.join(root, "sys"))
        self.cache = VersionCache(os.path.join(root, "cache"), self.tables,
                                  max_bytes=cache_max_bytes)
        self.registry = registry
        self.stores: dict[str, VersionedStore | ShardedStore] = {}
        self.load_errors: dict[str, Exception] = {}
        self.stores_root = os.path.join(root, "stores")
        os.makedirs(self.stores_root, exist_ok=True)
        if autoload:
            self._open_persisted()

    # -- persistence (segmented store layout) --------------------------------
    def _open_persisted(self) -> None:
        """Autoload every persisted store. A store that fails to load
        (corrupt segments, unsupported schema, ...) is skipped and its
        error recorded in ``load_errors`` (keyed by directory name) — one
        bad directory must not brick access to every other store under the
        root. ``open_store`` retries the load on direct access, surfacing
        the store's actual error."""
        from .segments import MANIFEST_NAME
        for d in sorted(os.listdir(self.stores_root)):
            p = os.path.join(self.stores_root, d)
            if not os.path.isdir(p):
                continue
            if (is_sharded_dir(p)
                    or os.path.exists(os.path.join(p, MANIFEST_NAME))
                    or os.path.exists(os.path.join(p, "meta.json"))):
                try:
                    st = open_any_store(p, lazy=True, device=self.device)
                except Exception as e:  # noqa: BLE001 — recorded, re-raised
                    self.load_errors[d] = e
                    continue
                self.stores[st.name] = st

    def store_path(self, name: str) -> str:
        from .segments import store_dir_name
        return os.path.join(self.stores_root, store_dir_name(name))

    def _persisted(self, name: str) -> bool:
        """Whether a store directory (either flavor) exists for ``name``."""
        from .segments import MANIFEST_NAME
        p = self.store_path(name)
        return (is_sharded_dir(p)
                or os.path.exists(os.path.join(p, MANIFEST_NAME))
                or os.path.exists(os.path.join(p, "meta.json")))

    def open_store(self, name: str) -> VersionedStore | ShardedStore:
        """The named store (sharded or not), transparently reopening it
        (lazy) from ``store_path(name)`` when it is not in memory — e.g.
        after a tiered-memory spill removed it from ``stores``.

        Raises:
          KeyError: the store neither exists in memory nor on disk.
        """
        st = self.stores.get(name)
        if st is None:
            if not self._persisted(name):
                raise KeyError(name)
            st = open_any_store(self.store_path(name), lazy=True,
                                device=self.device)
            self.stores[name] = st
        return st

    def create_store(self, name: str, schema: Sequence[FieldSchema], *,
                     shards: int = 1,
                     capacity: int = 1024) -> VersionedStore | ShardedStore:
        """Create (and register) a new store; ``shards > 1`` makes it a
        hash-partitioned ``ShardedStore`` — transparent to every query and
        persistence path above.

        Raises:
          ValueError: a store with this name already exists (in memory or
            persisted under the root).
        """
        if name in self.stores or self._persisted(name):
            raise ValueError(f"store {name} already exists")
        if shards > 1:
            st = ShardedStore(name, schema, n_shards=shards,
                              capacity=capacity, device=self.device)
        else:
            st = VersionedStore(name, schema, capacity=capacity,
                                device=self.device)
        self.stores[name] = st
        return st

    def flush(self, store_name: str | None = None) -> dict[str, dict]:
        """Persist stores to ``<root>/stores/<name>`` (incremental: only
        segments newer than each manifest's watermark are written).

        Args:
          store_name: one store (reopened from disk if a tiered-memory
            spill removed it from ``stores``), or None for every in-memory
            store (spilled stores were saved by the spill itself, so there
            is nothing of theirs left to flush).

        Returns:
          {store name: save stats} (see ``VersionedStore.save``).

        Raises:
          KeyError: unknown ``store_name``.
        """
        names = [store_name] if store_name is not None else list(self.stores)
        out: dict[str, dict] = {}
        for name in names:
            path = self.store_path(name)
            store = self.open_store(name)
            stats = store.save(path)
            out[name] = stats
            # index the manifest in the `files` table: segment bytes are
            # visible to ops/eviction accounting but never cache-evictable
            from .segments import MANIFEST_NAME
            manifest = (SHARD_MANIFEST_NAME if isinstance(store, ShardedStore)
                        else MANIFEST_NAME)
            self.tables.record_file(f"store-segments|{name}",
                                    os.path.join(path, manifest),
                                    "store-segment", True,
                                    nbytes=stats["disk_bytes"])
        return out

    # -- data-feeder interface (Fig. 3 left) --------------------------------
    def add_release(self, store_name: str, ts: int, text: str, *,
                    parser_name: str, label: str = "",
                    full_release: bool = True, shards: int = 1):
        """Parse and ingest one release into a store (created on first use).

        Args:
          store_name: target store (a new store is created with the
            parser's schema when absent).
          ts: release timestamp (strictly greater than the store's last).
          text: raw release file content for ``parser_name``.
          label: human-readable release label.
          full_release: paper semantics — keys absent from this release
            are tombstoned; False = patch semantics.
          shards: partition count used ONLY when the store is created by
            this call (>1 = hash-partitioned ShardedStore); an existing
            store keeps its own layout.

        Returns:
          VersionInfo with new/updated/deleted counts.

        Raises:
          KeyError: unknown parser. ValueError: non-monotonic ``ts``.
        """
        parser = self.registry.parsers[parser_name]
        keys, table = parser.parse_text(text)
        try:
            store = self.open_store(store_name)  # in memory, or spilled
        except KeyError:
            store = self.create_store(store_name, parser.schema(),
                                      shards=shards,
                                      capacity=max(16, len(keys)))
        info = store.update(ts, keys, table, label=label,
                            full_release=full_release)
        self.tables.record_update(store_name, info)
        return info

    def ingest_journal_path(self, store_name: str) -> str:
        """Sidecar ingest-journal directory for a store (under the root,
        next to — never inside — the store's segment directory)."""
        from .segments import store_dir_name
        return os.path.join(self.root, "ingest", store_dir_name(store_name))

    def add_release_stream(self, store_name: str, ts: int, source, *,
                           parser_name: str, label: str = "",
                           full_release: bool = True, shards: int = 1,
                           config=None, resumable: bool = True,
                           pressure_fn: Callable[[], float] | None = None):
        """Streaming sibling of ``add_release``: ingest a release from a
        file path / chunk iterable / ``callable(start) -> chunks`` without
        ever holding it in host memory, with shard-parallel update waves
        and (by default) a crash-resumable chunk journal under the root.

        After a crash, call again with the same arguments — journaled
        chunks replay and parsing resumes mid-file (core/ingest.py has the
        protocol). The store is flushed to its directory as part of the
        ingest (pre-release and post-commit), so a separate ``flush()`` is
        not needed for durability.

        Args:
          source: release file path (resumable via seek), iterable of text
            chunks, or ``callable(start_offset) -> chunk iterable``.
          config: ``IngestConfig`` pipeline knobs (None = defaults).
          resumable: journal parsed chunks for crash-resume. False skips
            the journal AND the pre/post store saves (purely in-memory
            ingest; call ``flush()`` yourself).
          pressure_fn: mutation backpressure source, e.g. a serving
            ``TieredStorePool.pressure`` (honoured when
            ``config.max_pressure`` is set).

        Returns:
          ``IngestReport`` (``.info`` is the release's VersionInfo;
          ``.already_committed`` when a resume found it already applied).
        """
        from .ingest import ingest_release
        parser = self.registry.parsers[parser_name]
        try:
            store = self.open_store(store_name)
        except KeyError:
            store = self.create_store(store_name, parser.schema(),
                                      shards=shards, capacity=1024)
        rep = ingest_release(
            store, source, parser, ts, label=label,
            full_release=full_release, config=config,
            journal_dir=(self.ingest_journal_path(store_name)
                         if resumable else None),
            store_dir=self.store_path(store_name) if resumable else None,
            pressure_fn=pressure_fn)
        if rep.info is not None:
            self.tables.record_update(store_name, rep.info)
        return rep

    # -- workflow-manager interface (Fig. 3 right) ---------------------------
    def generate_files(self, tool: str, store_name: str, *, t_version: int,
                       t_last: int | None = None,
                       key_filter: str | None = None,
                       run_id: str = "") -> GeneratedInput:
        """paper `generateFiles`: full version if t_last is None, else the
        increment (t_last, t_version]. Thin wrapper over the batched path."""
        return self.generate_files_batch([
            {"tool": tool, "store": store_name, "t_version": t_version,
             "t_last": t_last, "key_filter": key_filter, "run_id": run_id},
        ])[0]

    def generate_files_batch(self, requests: Sequence[Mapping]) -> list[GeneratedInput]:
        """Batched `generateFiles`. Each request is a mapping with keys
        ``tool``, ``store``, ``t_version`` and optional ``t_last`` /
        ``key_filter`` / ``run_id``. Returns GeneratedInputs aligned with
        the input order. All increments of a store group into ONE
        get_increments call; all uncached full versions group into ONE
        get_versions call per (store, fields, filter) — each a single
        batched superlog scan."""
        reqs = []
        cached0: list[str | None] = []
        for raw in requests:
            r = dict(raw)
            plugin = self.registry.tools[r["tool"]]
            parser = self.registry.parsers[plugin.generator.parser]
            store = self.open_store(r["store"])
            t_last = r.get("t_last")
            desc = descriptor(r["store"], -1 if t_last is None else t_last,
                              r["t_version"], filter_expr=r.get("key_filter") or "",
                              plugin=r["tool"], params=plugin.params)
            reqs.append((r, plugin, parser, store, desc))
            cached0.append(self.cache.get(desc))

        # -- increments: always materialized (the merge context needs the
        # changed-key sets even when the generated file is cached), one
        # batched scan per (store, significant, output-fields) group.
        # Cache hits only need keys/kinds, so they group with fields=().
        inc_groups: dict[tuple, list[int]] = {}
        for i, (r, plugin, _, _, _) in enumerate(reqs):
            if r.get("t_last") is not None:
                out = () if cached0[i] is not None else tuple(
                    plugin.generator.output_fields)
                key = (r["store"], tuple(plugin.generator.significant_fields),
                       out)
                inc_groups.setdefault(key, []).append(i)
        incs: dict[int, Increment] = {}
        for (sname, sig, out_fields), idxs in inc_groups.items():
            store = self.open_store(sname)
            pairs = [(reqs[i][0]["t_last"], reqs[i][0]["t_version"])
                     for i in idxs]
            uniq = list(dict.fromkeys(pairs))
            got = dict(zip(uniq, store.get_increments(
                uniq, significant_fields=list(sig), fields=list(out_fields))))
            for i, p in zip(idxs, pairs):
                incs[i] = got[p]

        # -- db-size context (e-value style corrections): batched per store.
        size_ts: dict[str, set] = {}
        for i in incs:
            r, _, _, store, _ = reqs[i]
            if "length" in store.fields:
                size_ts.setdefault(r["store"], set()).update(
                    (r["t_last"], r["t_version"]))
        sizes: dict[tuple[str, int], int] = {}
        for sname, tss in size_ts.items():
            store, tss = self.open_store(sname), sorted(tss)
            for t, view in zip(tss, store.get_versions(tss, fields=["length"])):
                # keyed by store.name: _merge_context reads it back that way
                sizes[(store.name, t)] = int(view.values["length"].sum())

        # -- cache check; collect the uncached full versions per group.
        results: list[GeneratedInput | None] = [None] * len(reqs)
        contexts: list[dict] = [None] * len(reqs)
        full_groups: dict[tuple, list[int]] = {}
        for i, (r, plugin, parser, store, desc) in enumerate(reqs):
            contexts[i] = self._merge_context(store, plugin, r.get("t_last"),
                                              r["t_version"], inc=incs.get(i),
                                              sizes=sizes)
            cached = cached0[i]
            if cached is not None:
                results[i] = _cached_result(cached, r, contexts[i])
            elif r.get("t_last") is None:
                key = (r["store"], tuple(plugin.generator.output_fields),
                       r.get("key_filter"))
                full_groups.setdefault(key, []).append(i)

        # -- batched full-version materialization.
        views: dict[int, object] = {}
        for (sname, out_fields, key_filter), idxs in full_groups.items():
            store = self.open_store(sname)
            tss = [reqs[i][0]["t_version"] for i in idxs]
            uniq = list(dict.fromkeys(tss))
            got = dict(zip(uniq, store.get_versions(
                uniq, fields=list(out_fields), key_filter=key_filter)))
            for i, t in zip(idxs, tss):
                views[i] = got[t]

        # -- format + cache-put everything still pending.
        for i, (r, plugin, parser, store, desc) in enumerate(reqs):
            if results[i] is not None:
                continue
            cached = self.cache.get(desc)
            if cached is not None:  # a duplicate earlier in this batch wrote it
                results[i] = _cached_result(cached, r, contexts[i])
                continue
            if r.get("t_last") is None:
                view = views[i]
                text, n_entries, mode = parser.format_view(view), len(view), "full"
            else:
                sub = _live_filtered(incs[i], r.get("key_filter"))
                text, n_entries, mode = parser.format_view(sub), len(sub), "increment"
            path = self.cache.put(desc, lambda p, text=text: _write_text(p, text),
                                  plugin=r["tool"], suffix=".txt")
            results[i] = GeneratedInput(path, mode, _t0(r), r["t_version"],
                                        n_entries, contexts[i])
        return results

    def merge_files(self, tool: str, previous: str, partial: str, *,
                    context: dict) -> str:
        """paper `mergeFiles`: merge a partial (incremental) tool output
        into the previous full output via the tool's OutputMerger.

        Args:
          tool: registered tool name; previous/partial: tool output text;
          context: the GeneratedInput.context of the incremental run
            (changed-key sets, db sizes).

        Returns:
          The merged full output (plain concatenation when the tool has
          no merger).

        Raises:
          KeyError: unknown tool.
        """
        plugin = self.registry.tools[tool]
        if plugin.merger is None:
            return previous + partial
        return plugin.merger.merge(previous, partial, context=context)

    # -- provenance-recorded tool execution ----------------------------------
    def run_tool(self, tool: str, store_name: str,
                 tool_fn: Callable[[str], str], *, t_version: int,
                 t_last: int | None = None, previous_output: str = "",
                 key_filter: str | None = None) -> tuple[str, GeneratedInput]:
        """Generate inputs -> run the unmodified tool -> merge outputs,
        recording provenance in the `runs` table."""
        run_id = f"{tool}-{store_name}-{t_version}-{time.time_ns()}"
        gen = self.generate_files(tool, store_name, t_version=t_version,
                                  t_last=t_last, key_filter=key_filter,
                                  run_id=run_id)
        self.tables.start_run(run_id, tool, [gen.path],
                              {"t_version": t_version, "t_last": t_last,
                               "mode": gen.mode})
        partial = tool_fn(gen.path)
        if t_last is None:
            merged = partial
        else:
            merged = self.merge_files(tool, previous_output, partial,
                                      context=gen.context)
        self.tables.finish_run(run_id, [])
        return merged, gen

    # -- helpers ---------------------------------------------------------------
    def _merge_context(self, store: VersionedStore, plugin: ToolPlugin,
                       t_last: int | None, t_version: int, *,
                       inc: Increment | None,
                       sizes: Mapping[tuple[str, int], int] | None = None) -> dict:
        ctx: dict = dict(plugin.params)   # tool knobs (e.g. max_hits_per_query)
        if t_last is None:
            return ctx
        if inc is None:  # direct callers outside the batch path
            inc = store.get_increment(
                t_last, t_version,
                significant_fields=list(plugin.generator.significant_fields),
                fields=[])
        ctx["deleted_keys"] = [k for k, kd in zip(inc.keys, inc.kind)
                               if kd == KIND_DELETED]
        ctx["updated_keys"] = [k for k, kd in zip(inc.keys, inc.kind)
                               if kd == KIND_UPDATED]
        ctx["new_keys"] = [k for k, kd in zip(inc.keys, inc.kind)
                           if kd == KIND_NEW]
        # database-size context for e-value style corrections
        if "length" in store.fields:
            sizes = sizes or {}
            for label, t in (("db_size_old", t_last), ("db_size_new", t_version)):
                val = sizes.get((store.name, t))
                if val is None:
                    val = int(store.get_version(t, fields=["length"])
                              .values["length"].sum())
                ctx[label] = val
        return ctx


def _t0(r: Mapping) -> int:
    """Increment start for a request; full versions report -1 (a t_last of
    0 is a valid timestamp and must not collapse to -1)."""
    return -1 if r.get("t_last") is None else r["t_last"]


def _cached_result(path: str, r: Mapping, context: dict) -> GeneratedInput:
    with open(path) as f:
        n = sum(1 for _ in f)
    return GeneratedInput(path, "cached", _t0(r), r["t_version"], n, context)


def _write_text(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
