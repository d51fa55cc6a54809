"""Sharded meta-database engine: hash-partitioned stores with
scatter-gather materialization (paper §II.B/§V).

The port of ``repro.core.shard`` to PyTorch. The paper scales GeStore by
spreading meta-database rows across HBase region servers so version
generation parallelizes with the data. This module is that scale-out axis:
a ``ShardedStore`` facade hash-partitions the entry keyspace over N
independent ``VersionedStore`` shards while preserving the full store API,
so every layer above (increment engine, serving, tiered memory) runs
unchanged. Its directories are the JAX package's byte for byte: either
package opens what the other saved.

Devices: ``ShardedStore(..., device=None)`` and ``ShardedStore.load(path,
device=None)`` run on the CUDA card (and raise without one) unless the
caller passes ``device="cpu"``. Every shard, and every lazy reload of a
spilled shard, lives on that one device. A parallel placement places a
separate stacked copy of the shards' superlogs (core/placement.py) and
never moves a shard.

Design invariants:

  * **Stable routing** — ``kernels/shard_route.route_keys`` maps a key to
    its shard as a pure function of the key bytes (width-stable hash, see
    that module; the CUDA kernel ``csrc/shard_route.cu``). The routing
    version is pinned in the shard manifest; a store written under one
    hash is never extended by another.
  * **Global row order** — the facade allocates global row ids in first-seen
    key order, exactly as an unsharded store would, and every scatter-gather
    query merges per-shard selections back into that order
    (``merge_shard_rows``). Sharded and unsharded stores therefore return
    *byte-identical* ``get_versions`` / ``get_increments`` results for the
    same history — the property the equivalence tests pin down.
  * **Aligned histories** — every release touches every shard (a shard with
    no keys in a full release still tombstones its vanished rows), so all
    shards share the facade's timestamp sequence and per-shard incremental
    save watermarks advance together.
  * **Per-shard persistence** — ``save`` writes one segmented store
    directory per shard (each incremental on its own) under a single
    ``SHARD_MANIFEST.json`` commit point holding the global key order.
    Like the unsharded ``MANIFEST.json``, the shard manifest rewrites the
    key list and version history on every save — segment bytes are O(new
    cells) but the manifest is O(keys); an append-only key index (like
    SEGMENTS.jsonl) is the known next step for very large keyspaces.
  * **Partial residency** — individual shards can be spilled to disk
    (``spill_shard``) and are transparently (lazily) reloaded on next
    access; ``log_epoch`` is the sum of shard epochs plus a floorable base,
    so the serve-layer plan-cache contract (equal epoch => identical bytes)
    survives per-shard spills exactly as it does whole-store ones.
  * **Device-parallel execution is pure placement** — under a parallel
    ``core/placement.py`` plan the per-shard fused-superlog scans collapse
    into one stacked launch per device (one device for every shard, or
    one shard per card), but the math per shard is exactly the serial
    loop's, so serial/stacked/mesh modes return byte-identical results
    across any device count — the equivalence suite pins this.
"""
from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

import numpy as np

from ..kernels import ops as kops
from ..kernels._compat import resolve_device
from ..kernels.shard_route import (ROUTING_VERSION, merge_shard_rows,
                                   route_keys)
from ..obs.trace import StageTimer
from . import store as store_mod
from .placement import PlacedSuperLog, ShardPlacement, plan_placement
from .store import (KIND_DELETED, KIND_UPDATED, FieldSchema,
                    Increment, Timestamp, VersionInfo, VersionView,
                    VersionedStore, _checked_cast, infer_field_schema)

SHARD_FORMAT = "gestore-shards-v1"
SHARD_MANIFEST_NAME = "SHARD_MANIFEST.json"


def shard_dir(path: str, i: int) -> str:
    """Directory of shard ``i`` under a sharded store directory."""
    return os.path.join(path, f"shard-{i:05d}")


def read_shard_manifest(root: str) -> dict | None:
    """Parsed SHARD_MANIFEST.json, or None when absent/unparseable."""
    p = os.path.join(root, SHARD_MANIFEST_NAME)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            man = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    return man if man.get("format") == SHARD_FORMAT else None


def _write_shard_manifest(root: str, man: dict) -> int:
    """Atomically commit the shard manifest; returns its byte size."""
    from .segments import _fsync_dir
    p = os.path.join(root, SHARD_MANIFEST_NAME)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, p)
    _fsync_dir(root)
    return os.path.getsize(p)


def is_sharded_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, SHARD_MANIFEST_NAME))


def open_any_store(path: str, *, lazy: bool = True, device=None):
    """Open a store directory regardless of flavor: a ShardedStore when a
    shard manifest is present, otherwise a plain VersionedStore, on
    ``device`` (None: the CUDA card)."""
    if is_sharded_dir(path):
        return ShardedStore.load(path, lazy=lazy, device=device)
    return VersionedStore.load(path, lazy=lazy, device=device)


def _as_bytes(keys: Sequence) -> list[bytes]:
    return [k.encode() if isinstance(k, str) else bytes(k) for k in keys]


def _cpu_count() -> int:
    """CPUs this process may run on (the JAX package's ``core/ingest.py``
    helper, copied: ingest is not ported yet)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


class ShardedStore:
    """Hash-partitioned meta-database over N independent VersionedStores.

    Drop-in for ``VersionedStore`` everywhere the engine touches stores:
    ``update``/``delete`` scatter a release across shards, ``get_versions``/
    ``get_increments`` fan a batched query out to per-shard fused-superlog
    scans and gather the results key-stably, ``save``/``load``/``compact``
    persist one segmented directory per shard under a shard manifest, and
    ``nbytes``/``drop_superlog``/``log_epoch``/``spill_shard`` plug into the
    tiered memory manager with per-shard granularity.

    ``device``: where every shard's scans, gathers and fingerprints and
    the routing kernel run. None means the CUDA card, and raises without
    one; pass ``"cpu"`` to run the kernels' plain torch versions on the
    host. Query results are the same bytes on either.
    """

    def __init__(self, name: str, schema: Sequence[FieldSchema], *,
                 n_shards: int = 4, capacity: int = 1024, device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.device = resolve_device(device)
        self.name = name
        self.n_shards = int(n_shards)
        self.schema: dict[str, FieldSchema] = {}
        self.versions: list[VersionInfo] = []
        self.row_keys: list[bytes] = []
        self.key_to_row: dict[bytes, int] = {}
        self._shard_of: list[int] = []            # global row -> shard id
        self._global_rows: list[list[int]] = [[] for _ in range(n_shards)]
        self._global_rows_np: list[np.ndarray | None] = [None] * n_shards
        per_shard_cap = max(16, capacity // n_shards)
        self._shards: list[VersionedStore | None] = [
            VersionedStore(self._shard_name(i), schema,
                           capacity=per_shard_cap, device=self.device)
            for i in range(n_shards)]
        self._spilled_epochs: dict[int, int] = {}  # shard id -> epoch at spill
        self._disk_bytes: dict[int, int] = {}      # shard id -> last save size
        self._dir: str | None = None               # set by save()/load()
        self._epoch_base = 0
        self._saved_epoch: int | None = None       # log_epoch at last save()
        # device-parallel execution (core/placement.py): planned lazily on
        # first query; the cross-shard stacked superlog is cached keyed on
        # the per-shard epoch tuple (so it survives spill/reload cycles,
        # which freeze and floor the epoch without changing content)
        self._placement: ShardPlacement | None = None
        self._placed: PlacedSuperLog | None = None
        for fs in schema:
            self.schema[fs.name] = fs

    def _shard_name(self, i: int) -> str:
        return f"{self.name}#shard{i:05d}"

    # -- epoch contract (mirrors VersionedStore.log_epoch) --------------------
    @property
    def log_epoch(self) -> int:
        """Monotone over every mutation of any shard: the sum of shard
        epochs (spilled shards contribute their epoch at spill time — the
        on-disk content is frozen, so the contribution is too) plus a
        base the tiered pool can floor after whole-store spills."""
        total = self._epoch_base
        for i, sh in enumerate(self._shards):
            total += (self._spilled_epochs[i] if sh is None
                      else sh.log_epoch)
        return total

    @property
    def _log_epoch(self) -> int:  # TieredStorePool floors through this name
        return self.log_epoch

    @_log_epoch.setter
    def _log_epoch(self, value: int) -> None:
        self._epoch_base += int(value) - self.log_epoch

    # -- shard residency ------------------------------------------------------
    def shard(self, i: int) -> VersionedStore:
        """Shard ``i``, transparently (lazily) reloading it if spilled."""
        sh = self._shards[i]
        if sh is None:
            if self._dir is None:
                raise RuntimeError(
                    f"shard {i} of {self.name} is spilled but the store has "
                    "no directory to reload it from")
            sh = VersionedStore.load(shard_dir(self._dir, i), lazy=True,
                                     device=self.device)
            # identical content => the pre-spill epoch is still correct;
            # flooring keeps the facade's epoch sum from moving backwards
            sh._log_epoch = max(sh._log_epoch, self._spilled_epochs[i])
            self._spilled_epochs.pop(i, None)
            self._shards[i] = sh
        return sh

    def resident_shard_ids(self) -> list[int]:
        return [i for i, sh in enumerate(self._shards) if sh is not None]

    def spill_shard(self, i: int | None = None, *,
                    root: str | None = None) -> int | None:
        """Spill one resident shard to disk and drop it from memory;
        returns the resident bytes freed, or None when no shard was
        resident to spill. ``root`` overrides (and becomes) the store
        directory.

        The spill commits through a whole-store incremental ``save()``
        (cells each shard already flushed are not rewritten), NOT a lone
        per-shard save: the shard manifest must stay consistent with every
        shard directory, or a crash after the spill would leave a
        previously-durable store unloadable (shards holding keys the
        stale manifest never heard of)."""
        if root is not None and root != self._dir:
            # retargeting: the saved-epoch watermark belongs to the OLD
            # directory — the new one has nothing yet
            self._saved_epoch = None
        if self._dir is None and root is None:
            raise RuntimeError(
                f"cannot spill shards of {self.name}: no store directory "
                "(save the store or pass root=)")
        target = root if root is not None else self._dir
        ids = self.resident_shard_ids() if i is None else [i]
        for sid in ids:
            sh = self._shards[sid]
            if sh is None:
                continue
            if self.log_epoch != self._saved_epoch:  # nothing new: skip the
                self.save(target)                    # save, drop straight away
            freed = sum(sh.nbytes().values())
            self._spilled_epochs[sid] = sh.log_epoch
            self._shards[sid] = None
            return freed
        return None

    def has_device_state(self) -> bool:
        return (self._placed is not None
                or any(sh is not None and sh._superlog is not None
                       for sh in self._shards))

    def drop_superlog(self) -> None:
        """Release every shard's device-resident superlog AND the
        cross-shard stacked copy (device -> host demotion)."""
        self._placed = None
        for sh in self._shards:
            if sh is not None:
                sh.drop_superlog()

    def nbytes(self) -> dict:
        """Resident-memory accounting summed over resident shards (spilled
        shards count zero — their cells live on disk). The device tier
        includes the stacked cross-shard superlog, so the tiered pool's
        device->host demotion reclaims it too."""
        out = {"host": 0, "device": 0}
        for sh in self._shards:
            if sh is not None:
                nb = sh.nbytes()
                out["host"] += nb["host"]
                out["device"] += nb["device"]
        if self._placed is not None:
            out["device"] += self._placed.nbytes()
        return out

    # -- shard->device placement (core/placement.py) --------------------------
    @property
    def placement(self) -> ShardPlacement:
        """Shard->device execution plan, auto-planned on first use (mesh
        when the host has a CUDA card per shard, else serial; a store on
        the CPU plans over the CPU alone; see ``plan_placement``). Assign
        to override — the serving pool pins one per store so every replica
        plans identically."""
        if self._placement is None:
            self._placement = plan_placement(
                self.n_shards, devices=(None if self.device.type == "cuda"
                                        else [self.device]))
        return self._placement

    @placement.setter
    def placement(self, value: ShardPlacement) -> None:
        self._placement = value
        self._placed = None

    def _placed_superlog(self) -> tuple[PlacedSuperLog, list]:
        """(stacked cross-shard superlog, per-shard superlogs), forcing
        residency first. Cached on the per-shard epoch tuple: spill/reload
        cycles freeze and floor epochs without changing content, so an
        equal tuple means the stacked device copy is still byte-valid.

        No shard is repinned (the JAX package assigns ``sh.device`` here):
        the shards stay whole on the store's device, and the stacked copy
        takes its own targets from the placement (core/placement.py)."""
        pl = self.placement
        shards = [self.shard(s) for s in range(self.n_shards)]
        sls = [sh.superlog() for sh in shards]
        epochs = tuple(sl.epoch for sl in sls)
        if self._placed is None or self._placed.epochs != epochs:
            self._placed = PlacedSuperLog(sls, pl, self.device)
        return self._placed, sls

    def _use_parallel(self, n_queries: int) -> bool:
        """Route this query through the device-parallel stacked path?
        Serial when the placement says so, and for a single distinct
        timestamp against any cold shard — that is the per-field
        ``select_at`` path whose lazy segment reads the stacked build
        would defeat (mirrors ``VersionedStore.get_versions``)."""
        if not self.placement.parallel:
            return False
        if n_queries == 1 and not all(
                sh is not None and sh._superlog_fresh()
                for sh in self._shards):
            return False
        return True

    # -- API parity helpers ---------------------------------------------------
    @property
    def fields(self) -> Mapping[str, FieldSchema]:
        """Field-name mapping (API parity with VersionedStore.fields for
        membership tests and default field lists)."""
        return self.schema

    @property
    def last_ts(self) -> Timestamp:
        return self.versions[-1].ts if self.versions else -1

    def _monotonic_floor(self) -> Timestamp:
        """Strictest monotonicity bound: the facade's own last_ts OR any
        resident shard's. They only diverge after a crash between shard
        saves and the facade-manifest commit (shards then reload "ahead"
        of the facade history) — refusing the colliding timestamp up
        front beats a mid-scatter shard-level ValueError."""
        last = self.last_ts
        for sh in self._shards:
            if sh is not None and sh.last_ts > last:
                last = sh.last_ts
        return last

    @property
    def n_rows(self) -> int:
        return len(self.row_keys)

    def add_field(self, fs: FieldSchema) -> None:
        """Schema evolution, applied to every shard. Shard residency is
        forced first and the first shard's add_field performs all
        validation, so no failure can leave shards with diverged schemas."""
        if fs.name in self.schema:
            raise ValueError(f"field {fs.name} exists")
        shards = [self.shard(i) for i in range(self.n_shards)]
        for sh in shards:
            sh.add_field(fs)
        self.schema[fs.name] = fs

    # -- routing --------------------------------------------------------------
    def _route(self, keys: Sequence[bytes]) -> np.ndarray:
        return route_keys(keys, self.n_shards, self.device)

    def _prepare_mutation(self, field_names: Sequence[str]
                          ) -> list[VersionedStore]:
        """Force every shard resident and pre-read every on-disk segment
        the coming mutation will touch (heads of the named fields + the
        EXISTS head). Failed reloads and corrupt segments therefore raise
        BEFORE any shard mutates — a failure between shard k-1 and k would
        desync the facade's global row order from the shards' local ones
        for good."""
        shards = [self.shard(s) for s in range(self.n_shards)]
        for sh in shards:
            sh.rebuild_heads([n for n in field_names if n in sh.fields])
            sh._ensure_exists_head()
        return shards

    def _alloc_rows(self, keys: Sequence[bytes], sid: np.ndarray) -> None:
        """Allocate global rows for unseen keys in first-seen order (the
        same order an unsharded store's _rows_for_keys would)."""
        for k, s in zip(keys, sid):
            if k not in self.key_to_row:
                row = len(self.row_keys)
                self.key_to_row[k] = row
                self.row_keys.append(k)
                self._shard_of.append(int(s))
                self._global_rows[int(s)].append(row)
                self._global_rows_np[int(s)] = None

    def _shard_rows(self, s: int) -> np.ndarray:
        """(n_local,) int64 map from shard-local row id to global row id."""
        arr = self._global_rows_np[s]
        if arr is None:
            arr = np.asarray(self._global_rows[s], np.int64)
            self._global_rows_np[s] = arr
        return arr

    # -- update / delete (§III.C, scattered) ----------------------------------
    def update(self, ts: Timestamp, keys: Sequence[bytes],
               table: Mapping[str, np.ndarray], *, label: str = "",
               full_release: bool = True,
               present_keys: Sequence[bytes] | None = None) -> VersionInfo:
        """Scatter one release across all shards. Semantics and returned
        counts match ``VersionedStore.update`` exactly; every shard is
        updated (a key-less shard in a full release still tombstones its
        vanished rows), so shard histories stay timestamp-aligned."""
        # everything fallible runs BEFORE any shard (or facade schema)
        # mutates — a failure between shard k-1 and k would desync the
        # facade's global row order from the shards' local ones for good:
        #   1. shard residency + segment reads; residency FIRST so the
        #      monotonicity floor sees crash-skewed spilled shards too
        self._prepare_mutation(list(table))
        floor = self._monotonic_floor()
        if ts <= floor:
            raise ValueError(
                f"timestamps must be monotonic: {ts} <= {floor}")
        keys = _as_bytes(keys)  # unconvertible keys raise before any mutation
        #   2. schema inference + validation, decided ONCE on the full
        #      value blocks so every shard adopts the dtype the unsharded
        #      store would have
        new_fields: dict[str, FieldSchema] = {}
        for name in table:
            if name not in self.schema:
                fs = infer_field_schema(name, table[name])
                self._shards[0]._validate_new_field(fs)
                new_fields[name] = fs
        #   3. value-checked casts + shape checks on the full blocks
        arrays = {}
        for name, v in table.items():
            fs = new_fields.get(name) or self.schema[name]
            arrays[name] = _checked_cast(name, np.asarray(v), fs.np_dtype)
            shaped = (arrays[name] if arrays[name].ndim > 1
                      else arrays[name][:, None])
            want = (len(keys), fs.width)
            assert shaped.shape == want, f"{name}: {shaped.shape} != {want}"
        #   4. only now register the new columns (facade + every shard)
        for fs in new_fields.values():
            self.add_field(fs)
        sid = self._route(keys)
        self._alloc_rows(keys, sid)
        present_by_shard: list[list[bytes] | None] = [None] * self.n_shards
        if present_keys is not None:
            pk = _as_bytes(present_keys)
            psid = self._route(pk)
            present_by_shard = [[] for _ in range(self.n_shards)]
            for k, s in zip(pk, psid):
                present_by_shard[s].append(k)
        n_new = n_upd = n_del = 0
        for s in range(self.n_shards):
            m = sid == s
            skeys = [k for k, mm in zip(keys, m) if mm]
            stable = {name: arr[m] for name, arr in arrays.items()}
            info = self.shard(s).update(
                ts, skeys, stable, label=label, full_release=full_release,
                present_keys=present_by_shard[s])
            n_new += info.n_new
            n_upd += info.n_updated
            n_del += info.n_deleted
        info = VersionInfo(ts=ts, label=label or str(ts),
                           n_entries=len(keys), n_new=n_new, n_updated=n_upd,
                           n_deleted=n_del)
        self.versions.append(info)
        return info

    def begin_release(self, ts: Timestamp, *, label: str = "",
                      full_release: bool = True,
                      parallel: bool | None = None) -> "ShardedReleaseSession":
        """Open a chunked wave-parallel mutation session for ONE release
        (see ``ShardedReleaseSession``). ``parallel=None`` applies shard
        sub-chunks concurrently whenever the store has more than one
        shard AND the host has more than one CPU; pass False to force the
        serial loop (the equivalence tests' reference mode), True to
        force threaded waves."""
        return ShardedReleaseSession(self, ts, label=label,
                                     full_release=full_release,
                                     parallel=parallel)

    def delete(self, ts: Timestamp, keys: Sequence[bytes], *,
               label: str = "") -> VersionInfo:
        """Tombstone ``keys`` at ``ts`` across their shards. Unknown keys
        raise KeyError before any shard mutates."""
        self._prepare_mutation([])  # residency first: the floor must see
        floor = self._monotonic_floor()  # crash-skewed spilled shards too
        if ts <= floor:
            raise ValueError(
                f"timestamps must be monotonic: {ts} <= {floor}")
        keys = _as_bytes(keys)
        for k in keys:
            if k not in self.key_to_row:
                raise KeyError(k)
        sid = np.asarray([self._shard_of[self.key_to_row[k]] for k in keys],
                         np.int32)
        for s in range(self.n_shards):
            skeys = [k for k, ss in zip(keys, sid) if ss == s]
            self.shard(s).delete(ts, skeys, label=label)
        info = VersionInfo(ts, label or f"delete@{ts}", len(keys), 0, 0,
                           len(keys))
        self.versions.append(info)
        return info

    # -- scatter-gather materialization ---------------------------------------
    def get_versions(self, ts_list: Sequence[Timestamp], *,
                     fields: Sequence[str] | None = None,
                     key_filter: str | Callable[[bytes], bool] | None = None,
                     include_deleted: bool = False,
                     cancel: Callable[[], bool] | None = None,
                     trace: dict | None = None) -> list[VersionView]:
        """Batched get_versions, fanned out to every shard's fused-superlog
        scan and merged back into global (unsharded) row order. Duplicate
        timestamps share one merged view, as in ``VersionedStore``.

        Under a parallel placement the per-shard scans collapse into ONE
        device-parallel stacked launch (``_get_versions_parallel``) —
        byte-identical results, the serial loop below is the fallback.

        ``cancel``/``trace`` follow the ``VersionedStore.get_versions``
        contract: cancellation is polled between per-shard (or stacked)
        stages, and stage seconds accumulate under the same keys."""
        fields = list(fields) if fields is not None else list(self.schema)
        ts_list = [int(t) for t in ts_list]
        if not ts_list:
            return []
        store_mod._check_cancel(cancel)
        uniq = list(dict.fromkeys(ts_list))
        if self._use_parallel(len(uniq)):
            by_t = dict(zip(uniq, self._get_versions_parallel(
                uniq, fields, key_filter, include_deleted,
                cancel=cancel, trace=trace)))
            return [by_t[t] for t in ts_list]
        per_shard = []
        for s in range(self.n_shards):
            store_mod._check_cancel(cancel)
            per_shard.append(self.shard(s).get_versions(
                uniq, fields=fields, key_filter=key_filter,
                include_deleted=include_deleted, cancel=cancel, trace=trace))
        with StageTimer(trace, "materialize"):
            by_t: dict[int, VersionView] = {}
            for qi, t in enumerate(uniq):
                views = [per_shard[s][qi] for s in range(self.n_shards)]
                rows, order = merge_shard_rows(
                    [self._shard_rows(s)[v.row_idx]
                     for s, v in enumerate(views)])
                values = {
                    name: np.concatenate([v.values[name]
                                          for v in views])[order]
                    for name in fields}
                by_t[t] = VersionView(
                    ts=t, keys=[self.row_keys[r] for r in rows],
                    row_idx=rows.astype(np.int32), values=values)
            return [by_t[t] for t in ts_list]

    def get_version(self, t: Timestamp, *,
                    fields: Sequence[str] | None = None,
                    key_filter: str | Callable[[bytes], bool] | None = None,
                    include_deleted: bool = False) -> VersionView:
        return self.get_versions([t], fields=fields, key_filter=key_filter,
                                 include_deleted=include_deleted)[0]

    def _get_versions_parallel(self, uniq, fields, key_filter,
                               include_deleted, cancel=None,
                               trace=None) -> list[VersionView]:
        """MERGED views for the unique timestamps, one per ``uniq`` entry,
        from ONE stacked launch: the cross-shard ``PlacedSuperLog`` answers
        every shard's boundary cumsums together (one shard per device under
        a mesh placement), exists resolution is one fused EXISTS gather,
        and each field's values come from one fused cross-shard ``take``
        with the gather indices already permuted into the final merged row
        order — no per-shard intermediate views, no re-concatenation. The
        math per element is exactly ``VersionedStore.get_versions`` + the
        facade merge — byte-identical to the serial loop."""
        with StageTimer(trace, "scan"):
            placed, sls = self._placed_superlog()
            nq, ns = len(uniq), self.n_shards
            bcums = placed.boundary_cums(uniq)
            ex = placed.exists_matrices(bcums, sls)
        store_mod._check_cancel(cancel)
        # per-shard flat selections over ALL queries (row-major (qi, row)
        # nonzero order == the per-query loop order the serial path uses)
        sel_cat, qi_cat = [], []
        for s in range(ns):
            mat = ex[s][1] if include_deleted else ex[s][0]
            if key_filter is None:
                qis, rr = np.nonzero(mat)
            else:
                parts = [self._shards[s]._filter_sel(
                    np.nonzero(mat[qi])[0], key_filter) for qi in range(nq)]
                rr = (np.concatenate(parts) if parts
                      else np.zeros(0, np.int64))
                qis = np.repeat(np.arange(nq), [len(p) for p in parts])
            sel_cat.append(rr)
            qi_cat.append(qis)
        # global merge of the whole wave in one stable sort: shards
        # partition the row space, so within a query (qi, global_row) keys
        # are unique and lexsort reproduces merge_shard_rows exactly
        big_qi = np.concatenate(qi_cat)
        big_g = np.concatenate(
            [self._shard_rows(s)[sel_cat[s]] for s in range(ns)])
        perm = np.lexsort((big_g, big_qi))
        rows_all = big_g[perm]
        lens_q = np.bincount(big_qi, minlength=nq)
        rows_q = np.split(rows_all, np.cumsum(lens_q)[:-1])
        values_q: list[dict] = [{} for _ in range(nq)]
        store_mod._check_cancel(cancel)
        with StageTimer(trace, "gather"):
            for name in fields:
                offs = placed.field_offsets(name, sls)
                iparts, kparts = [], []
                for s in range(ns):
                    f = sls[s].fields[name]
                    c = sls[s].counts(name, bcums[s])[qi_cat[s], sel_cat[s]]
                    iparts.append(offs[s] + np.clip(
                        f.ptr[sel_cat[s]] + c - 1, 0, max(f.n_cells - 1, 0)))
                    kparts.append(c > 0)
                for qi, v in enumerate(placed.take_cells(
                        name, np.concatenate(iparts)[perm],
                        np.concatenate(kparts)[perm], lens_q, sls)):
                    values_q[qi][name] = v
        with StageTimer(trace, "materialize"):
            return [VersionView(ts=t,
                                keys=[self.row_keys[r] for r in rows_q[qi]],
                                row_idx=rows_q[qi].astype(np.int32),
                                values=values_q[qi])
                    for qi, t in enumerate(uniq)]

    def get_increments(self, pairs: Sequence[tuple[Timestamp, Timestamp]], *,
                       significant_fields: Sequence[str] | None = None,
                       fields: Sequence[str] | None = None) -> list[Increment]:
        """Batched get_increments, scatter-gathered like get_versions."""
        sig = (list(significant_fields) if significant_fields is not None
               else list(self.schema))
        out_fields = list(fields) if fields is not None else list(self.schema)
        pairs = [(int(t0), int(t1)) for t0, t1 in pairs]
        if not pairs:
            return []
        upairs = list(dict.fromkeys(pairs))
        if self._use_parallel(len(upairs)):
            by_p = dict(zip(upairs, self._get_increments_parallel(
                upairs, sig, out_fields)))
            return [by_p[p] for p in pairs]
        per_shard = [self.shard(s).get_increments(
            upairs, significant_fields=sig, fields=out_fields)
            for s in range(self.n_shards)]
        by_pair: dict[tuple[int, int], Increment] = {}
        for qi, (t0, t1) in enumerate(upairs):
            incs = [per_shard[s][qi] for s in range(self.n_shards)]
            rows, order = merge_shard_rows(
                [self._shard_rows(s)[inc.row_idx]
                 for s, inc in enumerate(incs)])
            kind = np.concatenate([inc.kind for inc in incs])[order]
            values = {
                name: np.concatenate([inc.values[name] for inc in incs])[order]
                for name in out_fields}
            by_pair[(t0, t1)] = Increment(
                t0=t0, t1=t1, keys=[self.row_keys[r] for r in rows],
                row_idx=rows.astype(np.int32), kind=kind, values=values)
        return [by_pair[p] for p in pairs]

    def get_increment(self, t0: Timestamp, t1: Timestamp, *,
                      significant_fields: Sequence[str] | None = None,
                      fields: Sequence[str] | None = None) -> Increment:
        return self.get_increments(
            [(t0, t1)], significant_fields=significant_fields,
            fields=fields)[0]

    def _get_increments_parallel(self, upairs, sig,
                                 out_fields) -> list[Increment]:
        """MERGED increments for the unique windows from ONE stacked launch
        over the unique endpoints — the device-parallel twin of the serial
        per-shard ``get_increments`` loop + facade merge (same math, same
        bytes). Change detection stays on host (tiny count diffs); value
        materialization is one fused cross-shard ``take`` per field with
        deleted-row zeroing folded into the gather mask."""
        uniq = list(dict.fromkeys(t for p in upairs for t in p))
        q_of = {t: i for i, t in enumerate(uniq)}
        placed, sls = self._placed_superlog()
        np_ct, ns = len(upairs), self.n_shards
        bcums = placed.boundary_cums(uniq)
        ex = placed.exists_matrices(bcums, sls)
        names = list(dict.fromkeys(sig + out_fields))
        cnt = [{name: sls[s].counts(name, bcums[s]) for name in names}
               for s in range(ns)]
        i0_arr = np.asarray([q_of[t0] for t0, _ in upairs], np.intp)
        i1_arr = np.asarray([q_of[t1] for _, t1 in upairs], np.intp)
        # per-shard flat (pair, row) selections + kinds, all pairs at once
        # ((pi, row) nonzero order == the serial per-pair loop order)
        sel_cat, pi_cat, kind_cat = [], [], []
        for s in range(ns):
            exists = ex[s][0]
            changed = np.zeros((np_ct, self._shards[s].n_rows), bool)
            for name in sig:
                changed |= (cnt[s][name][i1_arr] - cnt[s][name][i0_arr]) > 0
            e0, e1 = exists[i0_arr], exists[i1_arr]
            new = e1 & ~e0
            deleted = e0 & ~e1
            updated = e1 & e0 & changed
            pis, rr = np.nonzero(new | deleted | updated)
            kind = np.zeros(len(rr), np.int8)  # zeros == KIND_NEW
            kind[updated[pis, rr]] = KIND_UPDATED
            kind[deleted[pis, rr]] = KIND_DELETED
            sel_cat.append(rr)
            pi_cat.append(pis)
            kind_cat.append(kind)
        # one stable sort merges every pair's rows (see _get_versions_parallel)
        big_pi = np.concatenate(pi_cat)
        big_g = np.concatenate(
            [self._shard_rows(s)[sel_cat[s]] for s in range(ns)])
        perm = np.lexsort((big_g, big_pi))
        rows_all = big_g[perm]
        kind_all = np.concatenate(kind_cat)[perm]
        lens_q = np.bincount(big_pi, minlength=np_ct)
        cuts = np.cumsum(lens_q)[:-1]
        rows_q = np.split(rows_all, cuts)
        kind_q = np.split(kind_all, cuts)
        not_deleted = kind_all != KIND_DELETED
        values_q: list[dict] = [{} for _ in upairs]
        for name in out_fields:
            offs = placed.field_offsets(name, sls)
            iparts, kparts = [], []
            for s in range(ns):
                f = sls[s].fields[name]
                c = cnt[s][name][i1_arr[pi_cat[s]], sel_cat[s]]
                iparts.append(offs[s] + np.clip(
                    f.ptr[sel_cat[s]] + c - 1, 0, max(f.n_cells - 1, 0)))
                kparts.append(c > 0)
            for qi, v in enumerate(placed.take_cells(
                    name, np.concatenate(iparts)[perm],
                    np.concatenate(kparts)[perm] & not_deleted,
                    lens_q, sls)):
                values_q[qi][name] = v
        return [Increment(t0=t0, t1=t1,
                          keys=[self.row_keys[r] for r in rows_q[qi]],
                          row_idx=rows_q[qi].astype(np.int32),
                          kind=kind_q[qi], values=values_q[qi])
                for qi, (t0, t1) in enumerate(upairs)]

    # -- compaction -----------------------------------------------------------
    def compact(self, before_ts: Timestamp, *, label: str = "",
                path: str | None = None) -> dict:
        """Compact every shard at ``before_ts`` (on disk too when ``path``
        is given) and collapse the facade's version prefix the same way
        ``VersionedStore.compact`` does."""
        stats = {"cells_dropped": 0}
        agg: dict[str, int] = {}
        for s in range(self.n_shards):
            st = self.shard(s).compact(
                before_ts, label=label,
                path=shard_dir(path, s) if path is not None else None)
            stats["cells_dropped"] += st.pop("cells_dropped")
            st.pop("versions_kept", None)
            for k, v in st.items():
                if isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
            if path is not None:
                self._disk_bytes[s] = st.get("disk_bytes",
                                             self._disk_bytes.get(s, 0))
        kept = [v for v in self.versions if v.ts > before_ts]
        n_base = sum(self.shard(s).versions[0].n_entries
                     for s in range(self.n_shards))
        base = VersionInfo(ts=before_ts,
                           label=label or f"compact@{before_ts}",
                           n_entries=n_base, n_new=n_base, n_updated=0,
                           n_deleted=0)
        self.versions = [base] + kept
        stats["versions_kept"] = len(kept) + 1
        stats.update(agg)
        if path is not None:
            self._dir = path
            stats["manifest_bytes"] = stats.get("manifest_bytes", 0) + \
                _write_shard_manifest(path, self._manifest_payload())
        return stats

    # -- persistence ----------------------------------------------------------
    def _manifest_payload(self) -> dict:
        return {
            "format": SHARD_FORMAT,
            "name": self.name,
            "n_shards": self.n_shards,
            "routing": ROUTING_VERSION,
            "schema": [dataclasses.asdict(f) for f in self.schema.values()],
            "keys": [k.decode("latin1") for k in self.row_keys],
            "versions": [dataclasses.asdict(v) for v in self.versions],
            "shard_dirs": [f"shard-{i:05d}" for i in range(self.n_shards)],
        }

    def save(self, path: str, *, force_full: bool = False) -> dict:
        """Persist every resident shard (each incremental against its own
        manifest watermark) plus the shard manifest as the commit point.
        Spilled shards were saved by the spill itself and are skipped.

        Returns aggregate stats in the ``VersionedStore.save`` shape, with
        ``mode`` = "incremental" when every written shard appended,
        "full" when every one rewrote, otherwise "mixed"."""
        os.makedirs(path, exist_ok=True)
        if path != self._dir:
            # saving to a NEW directory: spilled shards live only in the
            # old one — reload them (lazy) so every shard directory gets
            # written here, or the new manifest would reference shard dirs
            # that do not exist
            for sid in range(self.n_shards):
                if self._shards[sid] is None:
                    self.shard(sid)
        self._dir = path
        modes: list[str] = []
        agg = {"segments_written": 0, "bytes_written": 0, "raw_bytes": 0,
               "packed_bytes": 0, "disk_bytes": 0}
        for i, sh in enumerate(self._shards):
            if sh is None:  # frozen on disk since its spill-save
                agg["disk_bytes"] += self._disk_bytes.get(i, 0)
                continue
            st = sh.save(shard_dir(path, i), force_full=force_full)
            self._disk_bytes[i] = st["disk_bytes"]
            modes.append(st["mode"])
            for k in ("segments_written", "bytes_written", "raw_bytes",
                      "packed_bytes", "disk_bytes"):
                agg[k] += st[k]
        mb = _write_shard_manifest(path, self._manifest_payload())
        agg["bytes_written"] += mb
        agg["disk_bytes"] += mb
        agg["manifest_bytes"] = mb
        agg["mode"] = (modes[0] if modes and len(set(modes)) == 1
                       else "mixed" if modes else "incremental")
        agg["n_shards"] = self.n_shards
        self._saved_epoch = self.log_epoch
        return agg

    @classmethod
    def load(cls, path: str, *, lazy: bool = True,
             device=None) -> "ShardedStore":
        """Open a sharded store directory (written by either package): the
        shard manifest supplies the global key order and version history;
        each shard directory opens with the plain (lazy) segmented loader
        on ``device`` (None: the CUDA card, raising without one; ``"cpu"``:
        the host).

        Torn-save recovery: ``save()`` commits the shard directories first
        and the shard manifest last, so a crash in between leaves shards
        holding keys the facade manifest never heard of. Those keys are
        adopted (appended in (shard, local-row) order — the original
        cross-shard interleave of the torn release is unrecoverable, any
        deterministic order serves), so the previously durable store stays
        loadable and the torn release's committed cells stay reachable.

        Raises:
          FileNotFoundError: no shard manifest at ``path``.
          ValueError: the manifest was written under a different routing
            function (extending it would mis-route keys), or lists keys no
            shard holds (real divergence — the reverse of a torn save,
            which the commit order makes impossible).
        """
        man = read_shard_manifest(path)
        if man is None:
            raise FileNotFoundError(
                f"no {SHARD_MANIFEST_NAME} under {path}")
        if man.get("routing") != ROUTING_VERSION:
            raise ValueError(
                f"sharded store {path} uses routing "
                f"{man.get('routing')!r}; this build implements "
                f"{ROUTING_VERSION!r}")
        schema = [FieldSchema(**f) for f in man["schema"]]
        # capacity=16: the constructor's fresh shards are placeholders
        # replaced by the loaded ones on the next line
        obj = cls(man["name"], [], n_shards=man["n_shards"], capacity=16,
                  device=device)
        obj._shards = [VersionedStore.load(shard_dir(path, i), lazy=lazy,
                                           device=obj.device)
                       for i in range(obj.n_shards)]
        # adopt the shards' (possibly load-narrowed) schema dtypes
        loaded = obj._shards[0].schema
        obj.schema = {fs.name: loaded.get(fs.name, fs) for fs in schema}
        obj.row_keys = [k.encode("latin1") for k in man["keys"]]
        obj.key_to_row = {k: i for i, k in enumerate(obj.row_keys)}
        obj.versions = [VersionInfo(**v) for v in man["versions"]]
        obj._shard_of = [-1] * len(obj.row_keys)
        adopted = 0
        for s, sh in enumerate(obj._shards):
            rows = []
            for k in sh.row_keys:
                g = obj.key_to_row.get(k)
                if g is None:
                    # torn-save recovery (see docstring): adopt the key
                    g = len(obj.row_keys)
                    obj.key_to_row[k] = g
                    obj.row_keys.append(k)
                    obj._shard_of.append(s)
                    adopted += 1
                rows.append(g)
                obj._shard_of[g] = s
            obj._global_rows[s] = rows
        if any(s < 0 for s in obj._shard_of):
            missing = [obj.row_keys[i] for i, s in enumerate(obj._shard_of)
                       if s < 0][:3]
            raise ValueError(
                f"shard manifest of {path} lists keys no shard holds "
                f"(e.g. {missing})")
        obj._dir = path
        # a recovered (adopted-keys) facade does NOT match the on-disk
        # manifest — leave it save-dirty so the next spill/flush commits it
        obj._saved_epoch = None if adopted else obj.log_epoch
        return obj


class ShardedReleaseSession:
    """Chunked wave-parallel mutation of a ShardedStore for ONE release.

    The streaming twin of ``ShardedStore.update``: every ``apply(keys,
    table)`` routes the chunk with the ``shard_route`` kernel, allocates
    global rows in first-seen order (identical to the whole-file order for
    unique-key releases), then applies the per-shard sub-chunks as one
    concurrent *wave* — each shard's ``ReleaseSession.apply`` runs on its
    own single-thread executor. Shards partition the row space, so wave
    workers never share mutable state, and a shard's executor serializes
    ITS sub-applies in wave order — which lets ``apply`` return as soon
    as the wave is dispatched: routing + fingerprinting chunk k+1 overlaps
    the shard workers still applying chunk k. A worker failure surfaces on
    the next ``apply`` (or at ``finish()``), which is the right boundary:
    a mid-release session is discard-only anyway (the ingest journal owns
    crash recovery).

    ``finish()`` commits every shard's release (tombstone scans run
    per shard over its own touched rows), then appends the single facade
    VersionInfo — one atomically-validated release timestamp, exactly as
    the whole-file path. The committed store is byte-identical to a
    whole-file ``update`` of the concatenated chunks (cells, heads,
    counts, per-shard digest chains) for unique-key releases.
    """

    def __init__(self, store: ShardedStore, ts: Timestamp, *,
                 label: str = "", full_release: bool = True,
                 parallel: bool | None = None):
        #   residency FIRST so the monotonicity floor sees crash-skewed
        #   spilled shards too (mirrors update())
        shards = store._prepare_mutation([])
        floor = store._monotonic_floor()
        if ts <= floor:
            raise ValueError(
                f"timestamps must be monotonic: {ts} <= {floor}")
        self.store = store
        self.ts = int(ts)
        self.label = label
        self.full_release = full_release
        self.n_entries = 0
        self._sessions = [
            sh.begin_release(ts, label=label, full_release=full_release)
            for sh in shards]
        if parallel is None:
            # threaded waves only pay when there is a core to run them on
            parallel = store.n_shards > 1 and _cpu_count() > 1
        self._parallel = bool(parallel)
        # one single-thread executor PER SHARD: cross-shard parallel,
        # in-order per shard (required for byte-identical digest chains)
        self._execs = ([ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"ingest-{store.name}-s{s}")
            for s in range(store.n_shards)] if self._parallel else None)
        self._futs: list = []
        self._finished = False

    def _drain(self, *, wait: bool) -> None:
        """Surface worker failures; with ``wait`` also barrier the waves."""
        pending = []
        for f in self._futs:
            if wait or f.done():
                f.result()  # re-raises the worker's exception
            else:
                pending.append(f)
        self._futs = pending

    def apply(self, keys: Sequence[bytes],
              table: Mapping[str, np.ndarray]) -> int:
        """Route one chunk and apply its per-shard sub-chunks as one
        concurrent wave; returns the chunk entry count. Facade-level
        validation runs before any shard mutates (chunks already applied
        stay applied — the ingest journal owns crash recovery)."""
        if self._finished:
            raise RuntimeError("release session already finished")
        self._drain(wait=False)  # propagate any earlier wave's failure
        st = self.store
        keys = _as_bytes(keys)
        new_fields: dict[str, FieldSchema] = {}
        for name in table:
            if name not in st.schema:
                # chunk-local inference (see ReleaseSession.apply NOTE);
                # the ingest engine pre-declares the parser schema instead
                fs = infer_field_schema(name, table[name])
                st.shard(0)._validate_new_field(fs)
                new_fields[name] = fs
        arrays = {}
        for name, v in table.items():
            fs = new_fields.get(name) or st.schema[name]
            arr = _checked_cast(name, np.asarray(v), fs.np_dtype)
            arrays[name] = arr if arr.ndim > 1 else arr[:, None]
            want = (len(keys), fs.width)
            assert arrays[name].shape == want, (
                f"{name}: {arrays[name].shape} != {want}")
        if new_fields:
            self._drain(wait=True)  # shard dicts mutate: barrier the waves
            for fs in new_fields.values():
                st.add_field(fs)
        sid = st._route(keys)
        st._alloc_rows(keys, sid)
        # fingerprint the whole chunk ONCE per field: one kernel launch
        # each instead of n_shards small ones inside the sub-applies (the
        # dominant per-wave fixed cost); shards slice the shared result
        fps = {name: kops.fingerprint_rows(arr, st.device)
               for name, arr in arrays.items()}
        names = list(table)
        for s in range(st.n_shards):
            m = sid == s
            if not m.any():
                continue  # empty sub-chunk: nothing to apply, digest-neutral
            skeys = [k for k, mm in zip(keys, m) if mm]
            stable = {name: arr[m] for name, arr in arrays.items()}
            sfps = {name: fp[m] for name, fp in fps.items()}
            sh, sess = st.shard(s), self._sessions[s]

            def work(sh=sh, sess=sess, skeys=skeys, stable=stable,
                     sfps=sfps):
                # pre-read this shard's on-disk segments (corrupt segments
                # raise here, before the shard mutates), then apply
                sh.rebuild_heads([n for n in names if n in sh.fields])
                sess.apply(skeys, stable, _precast=True, _fps=sfps)

            if self._execs is not None:
                self._futs.append(self._execs[s].submit(work))
            else:
                work()
        self.n_entries += len(keys)
        return len(keys)

    def finish(self) -> VersionInfo:
        """Barrier the in-flight waves, commit every shard's release
        (concurrently under a parallel session — tombstone scans are
        per-shard too) and append the single facade version record."""
        if self._finished:
            raise RuntimeError("release session already finished")
        self._finished = True
        try:
            self._drain(wait=True)
            if self._execs is not None:
                futs = [ex.submit(sess.finish)
                        for ex, sess in zip(self._execs, self._sessions)]
                infos = [f.result() for f in futs]
            else:
                infos = [sess.finish() for sess in self._sessions]
        finally:
            self.close()
        info = VersionInfo(ts=self.ts, label=self.label or str(self.ts),
                           n_entries=self.n_entries,
                           n_new=sum(i.n_new for i in infos),
                           n_updated=sum(i.n_updated for i in infos),
                           n_deleted=sum(i.n_deleted for i in infos))
        self.store.versions.append(info)
        return info

    def close(self) -> None:
        """Release the wave executors (idempotent; finish() calls it)."""
        if self._execs is not None:
            for ex in self._execs:
                ex.shutdown(wait=True)
            self._execs = None
