"""GeStore version-materialization service (the serving face of §III.C).

Production platforms re-run analyses against many pinned meta-database
versions concurrently (the paper's motivating workload; OrpheusDB's
multi-version checkout makes the same case for relational data). This
service accepts concurrent get_version-style requests, groups them by store
into timestamp batches, and serves each batch through the store's fused
superlog (core/store._SuperLog + kernels/batched_select.py) — Q versions
cost one batched scan, not Q x F kernel launches.

Materialized views are memoized in an LRU *plan cache* keyed on
``(store, log_epoch)``: a store mutation bumps its epoch, so stale plans
age out naturally without explicit invalidation hooks. Per-host state is
just the queue + cache; a fleet scales this horizontally exactly like
serve/scheduler.py does for token serving.

Tiered memory management: a host serving hundreds of stores cannot keep
every superlog device-resident, nor every cell log in host RAM. When the
service is given a memory budget it wraps its stores in a
``TieredStorePool`` that tracks per-store resident bytes
(``VersionedStore.nbytes()``) and demotes the coldest stores one tier at a
time — device -> host (drop the fused superlog) then host -> disk
(segmented ``save()`` + drop the store object). A spilled store is
transparently reopened with a lazy ``load()`` on next access, and its
``log_epoch`` is floored above the spilled epoch so plan-cache entries from
before the spill can never alias a post-spill mutation.

In the port the device tier is the memory of the store's device (the CUDA
card, or the host for a ``device="cpu"`` store): ``nbytes()["device"]``
counts the superlog's uploaded buffers and a sharded store's stacked copy.
A spilled store reopens on the device it was spilled from, and a sharded
store's placement is planned over that device's kind.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Iterator, Mapping, Sequence

from ..core.placement import plan_placement
from ..core.segments import store_dir_name
from ..core.shard import open_any_store
from ..core.store import VersionedStore, VersionView
from ..obs import RECORDER, REGISTRY


@dataclasses.dataclass(frozen=True)
class VersionRequest:
    """One version-materialization request."""
    store: str
    ts: int
    fields: tuple | None = None
    key_filter: str | None = None
    include_deleted: bool = False

    def plan_key(self) -> tuple:
        return (self.ts, self.fields, self.key_filter, self.include_deleted)

    def group_key(self) -> tuple:
        """Requests sharing a group materialize in one get_versions call."""
        return (self.store, self.fields, self.key_filter, self.include_deleted)


class TieredStorePool:
    """Mapping-like store pool enforcing a resident-memory budget.

    Tracks per-store resident bytes and evicts the least-recently-used
    stores tier by tier until the total fits ``budget_bytes``:

      1. device -> host: drop the fused superlog (cheap; the next batched
         query rebuilds it from the host CSR).
      2. host -> disk: segmented ``save()`` to ``spill_root/<store>`` and
         drop the in-memory store. The next ``pool[name]`` reopens it with
         a lazy load, so only the segments a query touches are re-read.
         Sharded stores (core/shard.py) take this tier one shard at a
         time: the facade stays admitted with partial residency and only
         leaves the pool when every shard is already on disk.

    The pool operates on the LIVE backing dict when given one (including a
    GeStore facade's ``stores`` dict): spilling removes the entry from
    that dict too, so the memory is actually reclaimable and other holders
    of the dict see the store disappear instead of mutating an orphan.
    With a GeStore facade, spills go to ``GeStore.store_path(name)`` — the
    same directory ``flush()``/``open_store()`` use — so the facade and
    the pool always agree on where a spilled store lives.

    Epoch safety: before spilling (or replacing via ``add``), the store's
    ``log_epoch`` is recorded and the next store served under that name is
    floored above it, so any cache keyed on ``(store, log_epoch)`` (e.g.
    the service plan cache) can never confuse old content with new.
    """

    def __init__(self, stores, *, budget_bytes: int | None = None,
                 spill_root: str | None = None,
                 shard_placement=None):
        """Args:
          stores: a GeStore facade or {name: VersionedStore} mapping. A
            dict (or a facade's dict) is shared live; other mappings are
            snapshotted.
          budget_bytes: total resident (host+device) byte budget enforced
            by ``enforce()``; None disables eviction.
          spill_root: directory for host->disk spills; None limits
            eviction to the device->host tier unless a GeStore facade
            supplies its own store paths.
          shard_placement: shard->device execution policy pinned onto
            every sharded store the pool serves (admitted now, ``add``-ed
            later, or reloaded after a spill — reloads must not silently
            re-plan). A ``core.placement.ShardPlacement``, or a force
            string ("parallel"/"serial") planned per store's shard count;
            None leaves stores to auto-plan (see ``plan_placement``).
        """
        self._facade = stores if hasattr(stores, "store_path") else None
        backing = getattr(stores, "stores", stores)
        self._stores: dict[str, VersionedStore] = (
            backing if isinstance(backing, dict) else dict(backing))
        self.budget_bytes = budget_bytes
        self.spill_root = spill_root
        self.shard_placement = shard_placement
        for st in self._stores.values():
            self._apply_placement(st)
        self._spilled: dict[str, str] = {}        # name -> save path
        self._spilled_device: dict[str, object] = {}  # name -> its device
        self._epoch_floor: dict[str, int] = {}
        self._lru: OrderedDict[str, None] = OrderedDict(
            (n, None) for n in self._stores)
        self.stats = {"demotions": 0, "spills": 0, "shard_spills": 0,
                      "reloads": 0}
        # decayed disk-churn score feeding pressure() — see that docstring
        self._thrash = 0.0

    def _spill_path(self, name: str) -> str | None:
        if self._facade is not None:
            return self._facade.store_path(name)
        if self.spill_root is not None:
            # store_dir_name, not fs_name: names that sanitize identically
            # ('a/b' vs 'a_b') must not spill over each other's directory
            return os.path.join(self.spill_root, store_dir_name(name))
        return None

    def _apply_floor(self, name: str, st: VersionedStore) -> VersionedStore:
        floor = self._epoch_floor.get(name, 0)
        if st._log_epoch < floor:
            st._log_epoch = floor
        return st

    def _apply_placement(self, st) -> None:
        """Pin the pool's shard->device policy onto a sharded store (plain
        stores have no placement and pass through untouched). A force
        string plans over the store's devices, as ``ShardedStore.placement``
        does: every CUDA card for a store on the card, the host alone for
        a CPU store. The port never repins a shard, so a reload gets the
        policy again here."""
        sp = self.shard_placement
        if sp is None or not hasattr(st, "placement"):
            return
        if isinstance(sp, str):
            sp = plan_placement(st.n_shards, force=sp, devices=(
                None if st.device.type == "cuda" else [st.device]))
        st.placement = sp

    # -- mapping interface ----------------------------------------------------
    def __getitem__(self, name: str) -> VersionedStore:
        st = self._stores.get(name)
        if st is None:
            path = self._spilled.get(name)
            if path is None:
                raise KeyError(name)
            # load first, forget the spill record only on success: a failed
            # reload (e.g. CorruptSegmentError) must keep surfacing instead
            # of decaying into a KeyError on the next access. open_any_store
            # dispatches on the directory flavor, so sharded stores round-
            # trip through spills too; the store comes back on the device
            # it was spilled from
            st = self._apply_floor(name, open_any_store(
                path, lazy=True, device=self._spilled_device[name]))
            self._apply_placement(st)
            del self._spilled[name]
            del self._spilled_device[name]
            self._stores[name] = st
            self.stats["reloads"] += 1
            self._thrash += 1.0
            REGISTRY.counter("pool.reloads").inc()
            RECORDER.record("pool_reload", store=name, path=path)
        elif name in self._spilled:
            # someone else (e.g. GeStore.open_store) reloaded it into the
            # shared dict first; adopt it and keep the epoch guarantee
            del self._spilled[name]
            del self._spilled_device[name]
            self._apply_floor(name, st)
        self._lru[name] = None
        self._lru.move_to_end(name)
        return st

    def __contains__(self, name: object) -> bool:
        return name in self._stores or name in self._spilled

    def __iter__(self) -> Iterator[str]:
        yield from {**dict.fromkeys(self._stores),
                    **dict.fromkeys(self._spilled)}

    def __len__(self) -> int:
        return len(self._stores) + len(self._spilled)

    def keys(self):
        return list(self)

    def add(self, name: str, store: VersionedStore) -> None:
        """Register a store created after pool construction. Replacing an
        existing (or spilled) name advances the epoch floor past the old
        store, so plan-cache entries for it can never serve the new one."""
        old = self._stores.get(name)
        if old is not None:
            self._epoch_floor[name] = max(self._epoch_floor.get(name, 0),
                                          old.log_epoch + 1)
        self._stores[name] = self._apply_floor(name, store)
        self._apply_placement(store)
        self._spilled.pop(name, None)
        self._spilled_device.pop(name, None)
        self._lru[name] = None

    # -- accounting + eviction ------------------------------------------------
    def resident_bytes(self) -> int:
        """Total host+device bytes of every in-memory store."""
        return sum(sum(st.nbytes().values()) for st in self._stores.values())

    #: pressure() = thrash / PRESSURE_SCALE, thrash halving per enforce():
    #: a pool re-spilling what it just reloaded (2 events/cycle) converges
    #: on thrash 4.0 => pressure 1.0, the canonical "thrashing" level.
    PRESSURE_DECAY = 0.5
    PRESSURE_SCALE = 4.0

    def pressure(self) -> float:
        """Backpressure signal for the serving layer, in [0, inf).

        A decayed count of disk-tier churn events (whole-store spills,
        shard spills, and lazy reloads; device->host demotions are cheap
        and excluded): each event adds 1, and every ``enforce()`` cycle
        halves the accumulated score before adding its own events. The
        score is therefore deterministic — a function of the event
        sequence, not of wall time — which the seeded scheduling tests
        rely on. Calibration: 0 = calm (a pool comfortably within budget
        decays to 0 geometrically); >= 1.0 = thrashing (the steady state
        of a pool that reloads a store every wave only to spill it again).
        The front door (serve/frontdoor.py) degrades reads to serial at
        ``serial_pressure`` and sheds new reads at ``shed_pressure``."""
        return self._thrash / self.PRESSURE_SCALE

    def enforce(self) -> int:
        """Evict coldest-first until within budget; returns evictions
        performed (a demotion, a shard spill, and a whole-store spill each
        count one). Resident bytes are computed once and maintained
        incrementally, so one call is one walk over the pool, not
        O(stores) walks.

        Sharded stores (anything exposing ``spill_shard``) evict with
        per-shard granularity: shards spill to disk one at a time (the
        facade stays admitted with partial residency, reloading spilled
        shards lazily on the next query), and only when every shard is
        out does the facade itself leave the pool like a plain store."""
        if self.budget_bytes is None:
            return 0
        self._thrash *= self.PRESSURE_DECAY
        per_store = {name: sum(st.nbytes().values())
                     for name, st in self._stores.items()}
        total = sum(per_store.values())
        n = 0

        def recount(name, st):
            nonlocal total
            now = sum(st.nbytes().values())
            total -= per_store[name] - now
            per_store[name] = now

        # coldest first; stores never served via the pool come last
        order = list(self._lru) + [m for m in self._stores
                                   if m not in self._lru]
        for name in order:
            if total <= self.budget_bytes:
                break
            st = self._stores.get(name)
            if st is None:
                continue
            if st.has_device_state():               # tier 1: device -> host
                st.drop_superlog()
                self.stats["demotions"] += 1
                REGISTRY.counter("pool.demotions").inc()
                n += 1
                recount(name, st)
                if total <= self.budget_bytes:
                    break
            path = self._spill_path(name)
            if path is None:
                continue
            if hasattr(st, "spill_shard"):          # tier 2a: shard by shard
                while (total > self.budget_bytes
                       and st.spill_shard(root=path) is not None):
                    self.stats["shard_spills"] += 1
                    self._thrash += 1.0
                    REGISTRY.counter("pool.shard_spills").inc()
                    RECORDER.record("pool_shard_spill", store=name,
                                    path=path)
                    n += 1
                    recount(name, st)
                if st.resident_shard_ids():
                    continue  # partial residency: the facade stays admitted
                # every shard on disk: fall through and drop the facade too
                # — its key index is unaccounted host memory (save() below
                # costs one manifest re-commit at most)
            st.save(path)                           # tier 2: host -> disk
            self._epoch_floor[name] = st.log_epoch + 1
            self._spilled[name] = path
            self._spilled_device[name] = st.device
            del self._stores[name]
            self._lru.pop(name, None)
            total -= per_store.pop(name, 0)
            self.stats["spills"] += 1
            self._thrash += 1.0
            REGISTRY.counter("pool.spills").inc()
            RECORDER.record("pool_spill", store=name, path=path)
            n += 1
        return n


class GeStoreService:
    """Concurrent batched version materialization over a set of stores.

    ``submit`` is thread-safe and returns a Future; ``flush`` drains the
    queue, batching per store. ``materialize`` is the synchronous
    convenience wrapper. Served views are memoized and shared across
    clients, so their arrays are read-only — copy before mutating.

    With ``memory_budget_bytes`` (and optionally ``spill_root``) set, the
    stores are wrapped in a ``TieredStorePool`` and the budget is enforced
    after every flush — cold stores demote device -> host -> disk and
    reload lazily from their segments on the next request for them.
    """

    def __init__(self, stores, *, max_batch: int = 64,
                 plan_cache_size: int = 16, max_views_per_plan: int = 256,
                 memory_budget_bytes: int | None = None,
                 spill_root: str | None = None,
                 shard_placement=None):
        """Args:
          stores: a GeStore facade, {name: VersionedStore} mapping, or an
            existing TieredStorePool.
          max_batch: max distinct timestamps per get_versions call.
          plan_cache_size: LRU capacity in (store, log_epoch) plans.
          max_views_per_plan: LRU capacity of views within one plan.
          memory_budget_bytes / spill_root: tiered-memory knobs (see
            TieredStorePool); both None = no eviction (seed behavior).
          shard_placement: shard->device policy for sharded stores (see
            TieredStorePool; a ShardPlacement or "parallel"/"serial").
            Builds a pool even without a memory budget so the policy
            sticks across adds and spill reloads.
        """
        backing = getattr(stores, "stores", stores)
        if isinstance(backing, TieredStorePool):
            self.pool: TieredStorePool | None = backing
        elif (memory_budget_bytes is not None or spill_root is not None
              or shard_placement is not None):
            # pass the original object: a GeStore facade carries the spill
            # paths its own flush()/open_store() use
            self.pool = TieredStorePool(stores,
                                        budget_bytes=memory_budget_bytes,
                                        spill_root=spill_root,
                                        shard_placement=shard_placement)
        else:
            self.pool = None
        # explicit None check: the pool defines __len__, so an empty pool is
        # falsy and `self.pool or backing` would silently bypass it
        self._stores: Mapping[str, VersionedStore] = (
            backing if self.pool is None else self.pool)
        self.max_batch = max_batch
        self.plan_cache_size = plan_cache_size
        self.max_views_per_plan = max_views_per_plan
        self._lock = threading.Lock()          # guards the pending queue
        self._flush_lock = threading.Lock()    # serializes plan cache + stats
        self._pending: list[tuple[VersionRequest, Future]] = []
        # (store, log_epoch) -> {plan_key: VersionView}, LRU over the epochs
        self._plans: OrderedDict[tuple, dict] = OrderedDict()
        self.stats = {"requests": 0, "batches": 0, "plan_hits": 0,
                      "plan_misses": 0}

    # -- request intake -------------------------------------------------------
    def submit(self, store: str, ts: int, *, fields: Sequence[str] | None = None,
               key_filter: str | None = None,
               include_deleted: bool = False) -> "Future[VersionView]":
        """Enqueue one version-materialization request (thread-safe).

        Args:
          store: store name; ts: version timestamp; fields/key_filter/
            include_deleted: forwarded to ``VersionedStore.get_versions``.

        Returns:
          A Future resolved by a later ``flush()`` with a shared, read-only
          VersionView (copy before mutating). The Future carries
          ``KeyError`` for an unknown store and any store-level error.
        """
        req = VersionRequest(store, int(ts),
                             tuple(fields) if fields is not None else None,
                             key_filter, include_deleted)
        fut: Future = Future()
        with self._lock:
            self._pending.append((req, fut))
            self.stats["requests"] += 1
        return fut

    def materialize(self, requests: Sequence[VersionRequest]) -> list[VersionView]:
        """Synchronous convenience: submit every request, flush once, and
        return the views aligned with ``requests``. Raises whatever the
        underlying store raised for the failing request, if any."""
        futs = [self.submit(r.store, r.ts, fields=r.fields,
                            key_filter=r.key_filter,
                            include_deleted=r.include_deleted)
                for r in requests]
        self.flush()
        return [f.result() for f in futs]

    # -- plan cache -----------------------------------------------------------
    def _plan(self, store_name: str) -> OrderedDict:
        store = self._stores[store_name]
        key = (store_name, store.log_epoch)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = OrderedDict()
        self._plans.move_to_end(key)
        while len(self._plans) > self.plan_cache_size:
            self._plans.popitem(last=False)
        return plan

    # -- batched service loop -------------------------------------------------
    def flush(self) -> int:
        """Serve every pending request; returns the number served.
        Concurrent flushes each drain their own slice of the queue and
        serialize on the plan cache (it is an unsynchronized OrderedDict)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        with self._flush_lock:
            return self._serve(pending)

    def serve_wave(self, items: list[tuple[VersionRequest, Future]], *,
                   cancel=None, trace: dict | None = None,
                   enforce_pool: bool = True) -> int:
        """Serve a pre-assembled wave, bypassing the submit queue — the
        front door's dispatch entry point (serve/frontdoor.py): it owns
        wave composition (per-tenant fairness, priority, deadlines) and
        this method owns execution (plan cache, batched scans, tiered
        budget). ``cancel``/``trace`` follow the
        ``VersionedStore.get_versions`` contract; ``enforce_pool=False``
        skips budget enforcement for callers that enforce once per pump
        cycle instead of per wave. Thread-safe (serializes with flush)."""
        with self._flush_lock:
            return self._serve(items, cancel=cancel, trace=trace,
                               enforce_pool=enforce_pool)

    def store(self, name: str):
        """The live store for ``name`` through the tiered pool (reloading
        a spilled store lazily) — the mutation path the front door uses.
        Raises KeyError for an unknown store."""
        return self._stores[name]

    def pool_pressure(self) -> float:
        """The tiered pool's backpressure signal (0.0 without a pool)."""
        return 0.0 if self.pool is None else self.pool.pressure()

    def enforce_pool(self) -> int:
        """Enforce the tiered budget now (0 evictions without a pool)."""
        return 0 if self.pool is None else self.pool.enforce()

    def _serve(self, pending: list[tuple[VersionRequest, Future]], *,
               cancel=None, trace: dict | None = None,
               enforce_pool: bool = True) -> int:
        groups: dict[tuple, list[tuple[VersionRequest, Future]]] = {}
        for req, fut in pending:
            groups.setdefault(req.group_key(), []).append((req, fut))
        for (store_name, fields, key_filter, include_deleted), items in groups.items():
            try:
                store = self._stores[store_name]
                plan = self._plan(store_name)
                todo = []  # deduped uncached plan keys, insertion-ordered
                for req, _ in items:
                    pk = req.plan_key()
                    if pk in plan or pk in todo:  # in-flight dup = a hit too
                        self.stats["plan_hits"] += 1
                    else:
                        todo.append(pk)
                        self.stats["plan_misses"] += 1
                for chunk in (todo[i:i + self.max_batch]
                              for i in range(0, len(todo), self.max_batch)):
                    views = store.get_versions(
                        [pk[0] for pk in chunk],
                        fields=list(fields) if fields is not None else None,
                        key_filter=key_filter,
                        include_deleted=include_deleted,
                        cancel=cancel, trace=trace)
                    self.stats["batches"] += 1
                    for view in views:
                        # memoized views are shared across clients: freeze
                        # them so in-place edits fail loudly instead of
                        # corrupting every later cache hit
                        for arr in view.values.values():
                            arr.setflags(write=False)
                        view.row_idx.setflags(write=False)
                    plan.update(zip(chunk, views))
                for req, fut in items:
                    pk = req.plan_key()
                    plan.move_to_end(pk)
                    view = plan[pk]
                    if fut.set_running_or_notify_cancel():  # skip cancelled
                        fut.set_result(view)
                # bound memory within one long-lived epoch too
                while len(plan) > self.max_views_per_plan:
                    plan.popitem(last=False)
            except Exception as e:
                REGISTRY.counter("service.wave_errors").inc()
                RECORDER.record("wave_error", store=store_name,
                                error=repr(e), requests=len(items))
                for _, fut in items:
                    if not fut.done() and fut.set_running_or_notify_cancel():
                        fut.set_exception(e)
        if enforce_pool and self.pool is not None:
            self.pool.enforce()
        return len(pending)
