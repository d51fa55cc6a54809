"""Multi-tenant serving front door: admission, fairness, backpressure.

The paper's platform serves meta-database versions to many concurrent
analysis jobs; OrpheusDB makes the same case for relational data — bolt-on
versioning behind a normal database interface that heavy concurrent
clients hit without knowing about it. ``GeStoreService`` gave us batched
execution and a plan cache, but nothing that looks like the door a
million users walk through: no per-tenant fairness, no admission control,
no deadline story, no backpressure when the tiered pool is thrashing.
This module is that door.

Request lifecycle::

    submit ──admission──▶ per-tenant queue ──schedule──▶ wave ──▶ dispatch
              (reject)      (priority/deadline)  (batch + riders)    │
                                                                     ▼
                                              GeStoreService.serve_wave
                                              (plan cache, fused scans)

**Admission control** (every rejection is one of these, and nothing else
is ever rejected — the property tests pin this):

  1. ``QueueFull`` — the tenant's queue already holds
     ``max_queue_per_tenant`` requests at submit time. Raised
     synchronously from ``submit*``.
  2. ``Overloaded`` — a *read* submitted while the tiered pool's
     ``pressure()`` is at or above ``shed_pressure`` (mutations are never
     pressure-shed: dropping an ingest loses data, dropping a read loses
     a retry). Raised synchronously from ``submit``.
  3. ``DeadlineExceeded`` — the request's deadline had passed when the
     scheduler considered it for dispatch. Delivered asynchronously
     through the request's future.

**Scheduling.** Tenants are served round-robin (the fairness bound: while
a tenant has pending work, every other tenant initiates at most one wave
before it runs — no starvation). Within a tenant, requests order by
``(-priority, deadline, seq)``: higher priority first, earlier deadline
breaks ties, submission order breaks those. Mutations dispatch alone and
in queue order; reads batch into waves.

**Batching.** A read wave groups compatible ``get_versions`` requests —
same ``(store, fields, key_filter, include_deleted)`` — first from the
initiating tenant's queue, then *riders* from other tenants, up to
``max_wave``. The wave dispatches through ``GeStoreService.serve_wave``,
which batches per ``(store, log_epoch)`` in its plan cache, so one fused
superlog scan answers the whole wave. "Up to batching" is the one relaxation
of priority order: a low-priority request may resolve early by riding a
compatible higher-priority wave (it never *delays* anyone — riders add
zero scans).

**Backpressure.** The tiered pool's ``pressure()`` (a deterministic
decayed spill/reload churn score, see ``TieredStorePool.pressure``) feeds
two thresholds: at ``serial_pressure`` read waves degrade to a single
request (the cold single-ts path avoids building whole-store superlogs
that would immediately be evicted again), and at ``shed_pressure`` new
reads are rejected at the door. Every dispatched wave carries a
cooperative-cancellation token, so a wave whose every request was
cancelled or shed aborts between stages instead of paying for device work
(``core.store.OperationCancelled``).

**Observability.** Every admitted request is minted a ``trace_id``
(``repro_torch.obs.trace.new_trace_id``) at submit; the wave it dispatches in
runs inside a ``span()`` carrying that id, so stage timings and failure
events all the way down to segment I/O land in the flight recorder
under the request's trace. Per-stage wall times (queue, batch-form,
scan, gather, materialize, exec, total) aggregate into bounded
``repro_torch.obs`` histograms — owned by a per-door ``MetricsRegistry`` so
two doors in one process never alias — surfaced as p50/p99 by
``stats()``, which ``chip_smoke.py``'s ``frontdoor`` phase reports.
Rejections (queue-full, pressure, deadline) are
counted per tenant and recorded as ``admission_reject`` flight-recorder
events.

**On the card.** With ``start()`` the store's kernels (the scans, chain
decode, the fingerprint, the keep mask, the route) launch from the
dispatcher thread. A thread that sets no stream of its own issues to the
card's default stream, the same stream as the main thread, and every
result reaches the host through a blocking copy on it: a wave's views
are complete when its futures resolve.

Determinism for tests: with an injected ``clock`` and a caller-driven
``pump()`` (no background thread), scheduling is a pure function of the
submission sequence — the seeded stress/property suites rely on this.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from typing import Callable, Mapping, Sequence

from ..obs import RECORDER
from ..obs.metrics import Histogram, MetricsRegistry
from ..obs.trace import new_trace_id, span

from .gestore_service import GeStoreService, VersionRequest

READ = "get_versions"
MUTATIONS = ("update", "delete", "compact")
STAGES = ("queue", "batch", "scan", "gather", "materialize", "exec", "total")


class AdmissionError(RuntimeError):
    """A request the front door refused; ``reason`` names the policy."""
    reason = "admission"


class QueueFull(AdmissionError):
    """The tenant's bounded queue was full at submit time."""
    reason = "queue_full"


class Overloaded(AdmissionError):
    """A read arrived while pool pressure was at/above ``shed_pressure``."""
    reason = "pressure"


class DeadlineExceeded(AdmissionError):
    """The deadline passed before the scheduler could dispatch the
    request (delivered via the future, not raised at submit)."""
    reason = "deadline"


@dataclasses.dataclass
class FrontDoorConfig:
    """Front-door policy knobs.

    Attributes:
      max_queue_per_tenant: admission bound per tenant queue (QueueFull
        beyond it).
      max_wave: max requests batched into one read wave (initiator +
        riders).
      serial_pressure: pool pressure at/above which read waves degrade to
        a single request.
      shed_pressure: pool pressure at/above which new reads are rejected
        (``Overloaded``). Mutations are never pressure-shed.
      default_priority: priority assigned when ``submit*`` gets none.
      clock: monotonic-seconds source for deadlines/latency; injectable
        so scheduling tests are deterministic.
      hist_cap: per-stage histogram ring capacity (memory bound).
    """
    max_queue_per_tenant: int = 64
    max_wave: int = 32
    serial_pressure: float = 0.5
    shed_pressure: float = 1.5
    default_priority: int = 0
    clock: Callable[[], float] = time.monotonic
    hist_cap: int = 8192


@dataclasses.dataclass
class Ticket:
    """One admitted request: queue entry + trace context + future."""
    seq: int
    tenant: str
    store: str
    kind: str                      # READ or one of MUTATIONS
    priority: int
    deadline: float | None         # absolute clock() time; None = never
    future: Future
    t_submit: float
    req: VersionRequest | None = None    # reads only
    payload: dict | None = None          # mutations only
    wave: int = -1                       # dispatch wave index
    rider: bool = False                  # batched into another's wave
    trace_id: str = ""                   # minted at admission

    def sort_key(self) -> tuple:
        return (-self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.seq)

    def group_key(self) -> tuple | None:
        return self.req.group_key() if self.req is not None else None


class FrontDoor:
    """The serving front door over a ``GeStoreService``.

    Drive it either caller-pumped (deterministic: ``pump()`` dispatches
    waves until idle) or with a background dispatcher thread
    (``start()``/``stop()``). Mutations execute on the dispatcher, so all
    store access is serialized through it — per-store mutation order is
    the per-tenant queue order, and a read submitted after a mutation's
    future resolved always observes that mutation (read-your-writes).

    Cross-tenant writes to one store are not ordered by the front door;
    the store's own timestamp-monotonicity guard makes such races loud
    (the losing update's future carries ``ValueError``) rather than
    corrupting — give each store a single writer tenant.
    """

    def __init__(self, stores, *, config: FrontDoorConfig | None = None,
                 **service_kwargs):
        """Args:
          stores: an existing ``GeStoreService``, or anything its
            constructor accepts (GeStore facade, name->store mapping,
            TieredStorePool).
          config: policy knobs (``FrontDoorConfig``).
          service_kwargs: forwarded to ``GeStoreService`` when ``stores``
            is not already one (e.g. ``memory_budget_bytes``,
            ``spill_root``, ``shard_placement``).
        """
        self.config = config or FrontDoorConfig()
        self.service = (stores if isinstance(stores, GeStoreService)
                        else GeStoreService(stores, **service_kwargs))
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: dict[str, list[Ticket]] = {}
        self._rr: list[str] = []      # tenant cycle, first-submit order
        self._rr_pos = 0
        self._seq = 0
        self._wave_no = 0
        self._dispatch_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stopping = False
        #: per-door registry: two doors in one process must not alias
        #: latency histograms (stats()["latency"]["total"]["n"] counts
        #: THIS door's requests only)
        self.metrics = MetricsRegistry()
        self._hists = {s: self.metrics.histogram(f"latency.{s}",
                                                 self.config.hist_cap)
                       for s in STAGES}
        self._tenant_hist: dict[str, Histogram] = {}
        self.counters = {
            "admitted": 0, "completed": 0, "failed": 0, "cancelled": 0,
            "rejected_queue_full": 0, "rejected_pressure": 0,
            "shed_deadline": 0, "waves": 0, "read_waves": 0,
            "mutation_waves": 0, "riders": 0, "serial_degrades": 0,
        }
        self.per_tenant: dict[str, dict] = defaultdict(
            lambda: {"admitted": 0, "completed": 0, "failed": 0,
                     "shed_deadline": 0, "rejected_queue_full": 0,
                     "rejected_pressure": 0})
        #: dispatch journal (one dict per wave) — the fairness/priority
        #: tests audit it; bounded by hist_cap like the histograms
        self.dispatch_log: list[dict] = []

    # -- intake / admission ---------------------------------------------------
    def submit(self, tenant: str, store: str, ts: int, *,
               fields: Sequence[str] | None = None,
               key_filter: str | None = None,
               include_deleted: bool = False,
               priority: int | None = None,
               timeout: float | None = None) -> "Future":
        """Admit one get_versions request (thread-safe).

        Args:
          tenant: workgroup identity (fairness + queue accounting unit).
          store/ts/fields/key_filter/include_deleted: forwarded to
            ``VersionedStore.get_versions`` via the service plan cache.
          priority: higher dispatches earlier within the tenant
            (default ``config.default_priority``).
          timeout: seconds from now to the deadline; a request still
            queued past it is shed with ``DeadlineExceeded`` (None =
            no deadline).

        Returns:
          Future resolving to a shared read-only ``VersionView``.

        Raises:
          QueueFull: the tenant queue is at ``max_queue_per_tenant``.
          Overloaded: pool pressure >= ``shed_pressure``.
        """
        if self.service.pool_pressure() >= self.config.shed_pressure:
            with self._lock:
                self.counters["rejected_pressure"] += 1
                self.per_tenant[tenant]["rejected_pressure"] += 1
            RECORDER.record("admission_reject", reason="pressure",
                            tenant=tenant, store=store,
                            pressure=self.service.pool_pressure())
            raise Overloaded(
                f"pool pressure {self.service.pool_pressure():.2f} >= "
                f"shed_pressure {self.config.shed_pressure}")
        req = VersionRequest(store, int(ts),
                             tuple(fields) if fields is not None else None,
                             key_filter, include_deleted)
        return self._admit(tenant, store, READ, priority, timeout, req=req)

    def submit_update(self, tenant: str, store: str, ts: int,
                      keys: Sequence, table: Mapping, *, label: str = "",
                      full_release: bool = True,
                      present_keys: Sequence | None = None,
                      priority: int | None = None,
                      timeout: float | None = None) -> "Future":
        """Admit a release ingest (``VersionedStore.update``); the future
        resolves to its ``VersionInfo``. Never pressure-shed. Raises
        QueueFull like ``submit``."""
        payload = dict(ts=int(ts), keys=keys, table=table, label=label,
                       full_release=full_release, present_keys=present_keys)
        return self._admit(tenant, store, "update", priority, timeout,
                           payload=payload)

    def submit_delete(self, tenant: str, store: str, ts: int,
                      keys: Sequence, *, label: str = "",
                      priority: int | None = None,
                      timeout: float | None = None) -> "Future":
        """Admit a tombstone release (``VersionedStore.delete``)."""
        payload = dict(ts=int(ts), keys=keys, label=label)
        return self._admit(tenant, store, "delete", priority, timeout,
                           payload=payload)

    def submit_compact(self, tenant: str, store: str, before_ts: int, *,
                       label: str = "", path: str | None = None,
                       priority: int | None = None,
                       timeout: float | None = None) -> "Future":
        """Admit a compaction (``VersionedStore.compact``); the future
        resolves to its stats dict."""
        payload = dict(before_ts=int(before_ts), label=label, path=path)
        return self._admit(tenant, store, "compact", priority, timeout,
                           payload=payload)

    def _admit(self, tenant, store, kind, priority, timeout, *,
               req=None, payload=None) -> Future:
        cfg = self.config
        now = cfg.clock()
        fut: Future = Future()
        with self._work:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = []
                self._rr.append(tenant)
                self._tenant_hist[tenant] = self.metrics.histogram(
                    f"tenant.{tenant}", cfg.hist_cap)
            if len(q) >= cfg.max_queue_per_tenant:
                self.counters["rejected_queue_full"] += 1
                self.per_tenant[tenant]["rejected_queue_full"] += 1
                RECORDER.record("admission_reject", reason="queue_full",
                                tenant=tenant, store=store, queued=len(q))
                raise QueueFull(
                    f"tenant {tenant!r}: {len(q)} queued >= "
                    f"max_queue_per_tenant {cfg.max_queue_per_tenant}")
            self._seq += 1
            t = Ticket(seq=self._seq, tenant=tenant, store=store, kind=kind,
                       priority=(cfg.default_priority if priority is None
                                 else int(priority)),
                       deadline=None if timeout is None else now + timeout,
                       future=fut, t_submit=now, req=req, payload=payload,
                       trace_id=new_trace_id("req"))
            bisect.insort(q, t, key=Ticket.sort_key)
            self.counters["admitted"] += 1
            self.per_tenant[tenant]["admitted"] += 1
            self._work.notify_all()
        return fut

    # -- scheduling -----------------------------------------------------------
    def _shed(self, t: Ticket) -> None:
        self.counters["shed_deadline"] += 1
        self.per_tenant[t.tenant]["shed_deadline"] += 1
        RECORDER.record("admission_reject", reason="deadline",
                        tenant=t.tenant, store=t.store, trace=t.trace_id)
        if t.future.set_running_or_notify_cancel():
            t.future.set_exception(DeadlineExceeded(
                f"deadline passed before dispatch (tenant {t.tenant!r}, "
                f"store {t.store!r})"))

    def _purge_expired_locked(self, q: list[Ticket], now: float) -> None:
        live = [t for t in q if t.deadline is None or t.deadline >= now]
        if len(live) != len(q):
            for t in q:
                if t.deadline is not None and t.deadline < now:
                    self._shed(t)
            q[:] = live

    def _form_wave_locked(self) -> list[Ticket] | None:
        """Pick the next wave under the scheduling policy (caller holds
        the lock): round-robin to the next tenant with live work, take its
        queue head, and — for reads — batch compatible requests from its
        own queue then riders from the other tenants'."""
        cfg = self.config
        now = cfg.clock()
        n_tenants = len(self._rr)
        head = None
        for _ in range(n_tenants):
            tenant = self._rr[self._rr_pos % n_tenants]
            self._rr_pos = (self._rr_pos + 1) % max(n_tenants, 1)
            q = self._queues[tenant]
            self._purge_expired_locked(q, now)
            if q:
                head = q.pop(0)
                break
        if head is None:
            return None
        head.wave = self._wave_no
        wave = [head]
        degraded = False
        if head.kind == READ:
            pressure = self.service.pool_pressure()
            if pressure >= cfg.serial_pressure:
                degraded = True
                self.counters["serial_degrades"] += 1
            else:
                gk = head.group_key()
                # same-tenant first, then riders in rr order: compatible
                # requests resolve with zero extra scans
                order = [head.tenant] + [t for t in self._rr
                                         if t != head.tenant]
                for tenant in order:
                    if len(wave) >= cfg.max_wave:
                        break
                    q = self._queues[tenant]
                    taken = []
                    for t in q:
                        if len(wave) + len(taken) >= cfg.max_wave:
                            break
                        if t.kind == READ and t.group_key() == gk:
                            if t.deadline is not None and t.deadline < now:
                                continue   # purged below with the rest
                            taken.append(t)
                    for t in taken:
                        q.remove(t)
                        t.rider = t.tenant != head.tenant
                        t.wave = self._wave_no
                        wave.append(t)
                        if t.rider:
                            self.counters["riders"] += 1
        self._wave_no += 1
        self.counters["waves"] += 1
        self.counters["read_waves" if head.kind == READ
                      else "mutation_waves"] += 1
        for t in wave:
            self._hists["queue"].record(now - t.t_submit)
        self.dispatch_log.append({
            "wave": head.wave, "tenant": head.tenant, "store": head.store,
            "kind": head.kind, "initiator": head.seq,
            "members": [t.seq for t in wave],
            "riders": [t.seq for t in wave if t.rider],
            "degraded": degraded, "pressure": self.service.pool_pressure(),
            "trace": head.trace_id,
        })
        del self.dispatch_log[:-cfg.hist_cap]
        return wave

    # -- dispatch -------------------------------------------------------------
    def _dispatch_once(self) -> bool:
        """Form and execute one wave; False when every queue is idle."""
        with self._dispatch_lock:
            t0 = time.perf_counter()
            with self._lock:
                wave = self._form_wave_locked()
            if wave is None:
                return False
            self._hists["batch"].record(time.perf_counter() - t0)
            if wave[0].kind == READ:
                self._execute_read_wave(wave)
            else:
                self._execute_mutation(wave[0])
            return True

    def _execute_read_wave(self, wave: list[Ticket]) -> None:
        futs = [t.future for t in wave]

        def cancelled() -> bool:
            return all(f.cancelled() for f in futs)

        items = [(t.req, t.future) for t in wave]
        head = wave[0]
        trace: dict[str, float] = {}
        t0 = time.perf_counter()
        # the wave runs under the initiator's trace id: stage timings and
        # any segment-read failure below land on this span in the recorder
        with span("read_wave", trace_id=head.trace_id, wave=head.wave,
                  tenant=head.tenant, store=head.store, members=len(wave)):
            self.service.serve_wave(items, cancel=cancelled, trace=trace)
        self._finish(wave, trace, time.perf_counter() - t0)

    def _execute_mutation(self, t: Ticket) -> None:
        t0 = time.perf_counter()
        if t.future.set_running_or_notify_cancel():
            try:
                with span("mutation", trace_id=t.trace_id, op=t.kind,
                          tenant=t.tenant, store=t.store):
                    store = self.service.store(t.store)
                    p = dict(t.payload)
                    if t.kind == "update":
                        out = store.update(p.pop("ts"), p.pop("keys"),
                                           p.pop("table"), **p)
                    elif t.kind == "delete":
                        out = store.delete(p.pop("ts"), p.pop("keys"), **p)
                    else:   # compact
                        out = store.compact(p.pop("before_ts"), **p)
                t.future.set_result(out)
            except Exception as e:  # noqa: BLE001 — delivered via future
                RECORDER.record("mutation_error", store=t.store,
                                op=t.kind, tenant=t.tenant,
                                trace=t.trace_id, error=repr(e))
                t.future.set_exception(e)
        self.service.enforce_pool()   # mutations grow stores: honor budget
        self._finish([t], {}, time.perf_counter() - t0)

    def _finish(self, wave: list[Ticket], trace: dict, exec_s: float) -> None:
        now = self.config.clock()
        with self._lock:
            for stage, secs in trace.items():
                self._hists[stage].record(secs)
            self._hists["exec"].record(exec_s)
            for t in wave:
                total = now - t.t_submit
                self._hists["total"].record(total)
                self._tenant_hist[t.tenant].record(total)
                f = t.future
                if f.cancelled():
                    self.counters["cancelled"] += 1
                elif f.done() and f.exception() is not None:
                    self.counters["failed"] += 1
                    self.per_tenant[t.tenant]["failed"] += 1
                else:
                    self.counters["completed"] += 1
                    self.per_tenant[t.tenant]["completed"] += 1

    # -- drive ----------------------------------------------------------------
    def pump(self, max_waves: int | None = None) -> int:
        """Dispatch waves on the calling thread until idle (or
        ``max_waves``); returns waves dispatched. The deterministic test
        entry point, and a valid way to run the door without a thread."""
        n = 0
        while max_waves is None or n < max_waves:
            if not self._dispatch_once():
                break
            n += 1
        return n

    def start(self) -> "FrontDoor":
        """Spawn the background dispatcher thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stopping = False
            self._thread = threading.Thread(target=self._run,
                                            name="frontdoor-dispatch",
                                            daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._work:
                while not self._stopping and not any(
                        self._queues.values()):
                    # timed wait: queued deadlines must be shed even when
                    # no new submit ever notifies again
                    self._work.wait(0.05)
                if self._stopping:
                    return
            self.pump()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the dispatcher thread; ``drain`` pumps remaining queued
        work on the calling thread first."""
        with self._work:
            self._stopping = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.pump()

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability --------------------------------------------------------
    def queued(self, tenant: str | None = None) -> int:
        """Requests currently queued (one tenant, or all)."""
        with self._lock:
            if tenant is not None:
                return len(self._queues.get(tenant, ()))
            return sum(len(q) for q in self._queues.values())

    def stats(self) -> dict:
        """Point-in-time snapshot: counters, per-stage p50/p99 latency
        histograms, pool pressure, and per-tenant totals."""
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "latency": {s: h.snapshot() for s, h in self._hists.items()},
                "pool_pressure": self.service.pool_pressure(),
                "queued": {t: len(q) for t, q in self._queues.items()},
                "per_tenant": {
                    t: {**c, **self._tenant_hist[t].snapshot()}
                    for t, c in self.per_tenant.items()},
                "service": dict(self.service.stats),
            }
            if self.service.pool is not None:
                out["pool"] = dict(self.service.pool.stats)
            return out
