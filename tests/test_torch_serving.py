"""The port's serving tier (``repro_torch.serve``: ``TieredStorePool``,
``GeStoreService``, ``FrontDoor``) against the JAX package's, on the CPU.

The cases of ``tests/test_frontdoor.py``, ``tests/test_tiered_memory.py``
and the pool and service cases of ``tests/test_sharded_store.py`` run
through both packages side by side, the port's stores with
``device="cpu"``. Each case keeps the JAX package's own assertions, on
both sides, and then compares the two sides exactly: every served view
(keys, row order, values and their dtypes), every caller-pumped front
door's ``dispatch_log`` wave for wave (less its per-process trace ids),
the door's counters and per-tenant totals, the service's and the pool's
stats and the stores' ``log_epoch`` and ``nbytes``. The stress case runs
the port's door on its dispatcher thread and holds every read against a
serial replay through the JAX package.
"""
import dataclasses
import glob
import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402  optional-hypothesis shim

import repro.core as jcore  # noqa: E402
import repro.core.placement as jplacement  # noqa: E402
import repro.core.segments as jsegments  # noqa: E402
import repro.core.shard as jshard  # noqa: E402
import repro.core.store as jstore  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.placement as tplacement  # noqa: E402
import repro_torch.core.segments as tsegments  # noqa: E402
import repro_torch.core.shard as tshard  # noqa: E402
import repro_torch.core.store as tstore  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.core.parsers import FastaParser as JFasta  # noqa: E402
from repro_torch.core.parsers import FastaParser as TFasta  # noqa: E402

SEED = 20260808


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's modules, and the keyword that puts its stores on
    the host (none for the JAX package)."""
    name: str
    core: types.ModuleType
    store: types.ModuleType
    shard: types.ModuleType
    placement: types.ModuleType
    segments: types.ModuleType
    serve: types.ModuleType
    obs: types.ModuleType
    fasta: type
    dev: dict

    def VersionedStore(self, name, schema, **kw):
        return self.store.VersionedStore(
            name, [self.store.FieldSchema(*f) for f in schema], **kw,
            **self.dev)

    def ShardedStore(self, name, schema, **kw):
        return self.shard.ShardedStore(
            name, [self.store.FieldSchema(*f) for f in schema], **kw,
            **self.dev)

    def GeStore(self, root, reg):
        return self.core.GeStore(root, reg, **self.dev)


JAX = Side("jax", jcore, jstore, jshard, jplacement, jsegments, jserve,
           jobs, JFasta, {})
TORCH = Side("torch", tcore, tstore, tshard, tplacement, tsegments, tserve,
             tobs, TFasta, {"device": "cpu"})
SIDES = (JAX, TORCH)


# -- comparison records -------------------------------------------------------

def view_rec(v):
    """A served view as plain bytes: equal records mean equal views."""
    return (v.ts, [bytes(k) for k in v.keys], str(v.row_idx.dtype),
            v.row_idx.tobytes(),
            {f: (str(a.dtype), a.shape, a.tobytes())
             for f, a in v.values.items()})


def fut_rec(f):
    """A resolved future: its view, its error's type, or a cancel."""
    if f.cancelled():
        return "cancelled"
    e = f.exception(0)
    if e is not None:
        return type(e).__name__
    r = f.result(0)
    return view_rec(r) if hasattr(r, "row_idx") else repr(r)


def log_rec(fd):
    """The dispatch log wave for wave, less the per-process trace ids."""
    return [{k: v for k, v in d.items() if k != "trace"}
            for d in fd.dispatch_log]


def stats_rec(fd):
    """``stats()`` less its clocks: counters, queue lengths, pressure,
    per-tenant totals, the service's and the pool's stats, and how many
    samples each latency histogram holds."""
    s = fd.stats()
    return {"counters": s["counters"], "queued": s["queued"],
            "pool_pressure": s["pool_pressure"], "service": s["service"],
            "pool": s.get("pool"),
            "per_tenant": {t: {k: v for k, v in c.items()
                               if not k.endswith("_ms")}
                           for t, c in s["per_tenant"].items()},
            "latency_n": {k: h["n"] for k, h in s["latency"].items()}}


def door_rec(fd, futs):
    return {"futures": [fut_rec(f) for f in futs], "log": log_rec(fd),
            "stats": stats_rec(fd)}


def side_by_side(case, *args):
    """Run ``case(side, *args)`` for both packages and require equal
    records."""
    j, t = (case(side, *args) for side in SIDES)
    assert t == j


# -- front door (tests/test_frontdoor.py) -------------------------------------

def mk_store(side, name, seed, n=24, releases=3, width=4):
    rng = np.random.default_rng(seed)
    st_ = side.VersionedStore(name, [("a", width, "int32")])
    keys = [f"{name}-k{i}" for i in range(n)]
    for v in range(1, releases + 1):
        st_.update(v * 10, keys,
                   {"a": rng.integers(0, 99, (n, width)).astype(np.int32)})
    return st_


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _riders(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    f1 = fd.submit("alice", "G", 20)
    f2 = fd.submit("bob", "G", 20)
    f3 = fd.submit("carol", "G", 30)
    assert fd.pump() == 1
    assert f1.result(0) is f2.result(0)
    assert len(f3.result(0).keys) == 24
    log = fd.dispatch_log
    assert len(log) == 1 and sorted(log[0]["members"]) == [1, 2, 3]
    assert sorted(log[0]["riders"]) == [2, 3]
    assert fd.counters["riders"] == 2 and fd.counters["waves"] == 1
    return door_rec(fd, [f1, f2, f3])


def test_riders_share_one_wave_and_one_view():
    side_by_side(_riders)


def _priority(side):
    stores = {n: mk_store(side, n, SEED + i) for i, n in enumerate("ABC")}
    fd = side.serve.FrontDoor(stores)
    futs = [fd.submit("t", "A", 10, priority=0),
            fd.submit("t", "B", 10, priority=9),
            fd.submit("t", "C", 10, priority=4)]
    fd.pump()
    assert [d["store"] for d in fd.dispatch_log] == ["B", "C", "A"]
    return door_rec(fd, futs)


def test_priority_orders_dispatch_within_tenant():
    side_by_side(_priority)


def _fifo(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    keys = [f"G-k{i}" for i in range(4)]
    tbl = {"a": np.ones((4, 4), np.int32)}
    f1 = fd.submit_update("w", "G", 40, keys, tbl, full_release=False)
    f2 = fd.submit_update("w", "G", 50, keys, tbl, full_release=False)
    f3 = fd.submit("w", "G", 50)
    fd.pump()
    assert [d["kind"] for d in fd.dispatch_log] == [
        "update", "update", "get_versions"]
    assert [len(d["members"]) for d in fd.dispatch_log] == [1, 1, 1]
    assert f1.result(0).ts == 40 and f2.result(0).ts == 50
    assert len(f3.result(0).keys) == 24
    return door_rec(fd, [f1, f2, f3])


def test_same_priority_is_fifo_and_mutations_dispatch_alone():
    side_by_side(_fifo)


def _read_your_writes(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    keys = [f"G-k{i}" for i in range(24)]
    fut = fd.submit_update("w", "G", 40, keys,
                           {"a": np.full((24, 4), 7, np.int32)})
    fd.pump()
    fut.result(0)
    got = fd.submit("r", "G", 40)
    fd.pump()
    assert (got.result(0).values["a"] == 7).all()
    return door_rec(fd, [fut, got])


def test_read_your_writes():
    side_by_side(_read_your_writes)


def _fairness(side):
    stores = {"A": mk_store(side, "A", SEED),
              "B": mk_store(side, "B", SEED + 1)}
    fd = side.serve.FrontDoor(stores,
                              config=side.serve.FrontDoorConfig(max_wave=1))
    futs = [fd.submit("big", "A", 20) for _ in range(10)]
    futs += [fd.submit("small", "B", 20) for _ in range(3)]
    fd.pump()
    tenants = [d["tenant"] for d in fd.dispatch_log]
    assert len(tenants) == 13
    small_waves = [i for i, t in enumerate(tenants) if t == "small"]
    assert small_waves[0] <= 2
    for a, b in zip(small_waves, small_waves[1:]):
        assert b - a <= 2, f"small starved between waves {a} and {b}"
    return door_rec(fd, futs)


def test_fairness_bounded_interleave():
    side_by_side(_fairness)


def _max_wave(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)},
                              config=side.serve.FrontDoorConfig(max_wave=2))
    futs = [fd.submit("t", "G", 20) for _ in range(5)]
    fd.pump()
    assert fd.counters["waves"] == 3
    assert all(len(d["members"]) <= 2 for d in fd.dispatch_log)
    return door_rec(fd, futs)


def test_max_wave_caps_batch():
    side_by_side(_max_wave)


def _queue_full(side):
    fd = side.serve.FrontDoor(
        {"G": mk_store(side, "G", SEED)},
        config=side.serve.FrontDoorConfig(max_queue_per_tenant=2))
    futs = [fd.submit("t", "G", 10), fd.submit("t", "G", 20)]
    with pytest.raises(side.serve.QueueFull):
        fd.submit("t", "G", 30)
    futs.append(fd.submit("u", "G", 10))
    assert fd.counters["rejected_queue_full"] == 1
    assert fd.pump() >= 1 and fd.queued() == 0
    futs.append(fd.submit("t", "G", 30))
    fd.pump()
    return door_rec(fd, futs)


def test_queue_full_rejects_at_submit():
    side_by_side(_queue_full)


def _deadline(side):
    clk = FakeClock()
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)},
                              config=side.serve.FrontDoorConfig(clock=clk))
    doomed = fd.submit("t", "G", 20, timeout=1.0)
    alive = fd.submit("t", "G", 20)
    clk.t = 5.0
    fd.pump()
    with pytest.raises(side.serve.DeadlineExceeded):
        doomed.result(0)
    assert len(alive.result(0).keys) == 24
    assert fd.counters["shed_deadline"] == 1
    assert fd.stats()["per_tenant"]["t"]["shed_deadline"] == 1
    return door_rec(fd, [doomed, alive])


def test_deadline_shed_via_future():
    side_by_side(_deadline)


def _pressure_sheds(side, tmp_path):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)},
                              memory_budget_bytes=1 << 30,
                              spill_root=str(tmp_path / side.name))
    fd.service.pool._thrash = 99.0
    assert fd.service.pool_pressure() >= fd.config.shed_pressure
    with pytest.raises(side.serve.Overloaded):
        fd.submit("t", "G", 20)
    keys = [f"G-k{i}" for i in range(4)]
    fut = fd.submit_update("t", "G", 40, keys,
                           {"a": np.ones((4, 4), np.int32)},
                           full_release=False)
    fd.pump()
    assert fut.result(0).ts == 40
    assert fd.counters["rejected_pressure"] == 1
    return door_rec(fd, [fut])


def test_pressure_sheds_reads_but_never_mutations(tmp_path):
    side_by_side(_pressure_sheds, tmp_path)


def _pressure_degrades(side, tmp_path):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)},
                              spill_root=str(tmp_path / side.name))
    cfg = fd.config
    fd.service.pool._thrash = cfg.serial_pressure * 4.0
    assert (cfg.serial_pressure <= fd.service.pool_pressure()
            < cfg.shed_pressure)
    f1 = fd.submit("a", "G", 20)
    f2 = fd.submit("b", "G", 20)
    fd.pump()
    assert fd.counters["serial_degrades"] == 2
    assert all(d["degraded"] and len(d["members"]) == 1
               for d in fd.dispatch_log)
    assert f1.result(0) is f2.result(0)
    return door_rec(fd, [f1, f2])


def test_pressure_degrades_wave_to_serial(tmp_path):
    side_by_side(_pressure_degrades, tmp_path)


def _failed_mutation(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    keys = [f"G-k{i}" for i in range(4)]
    bad = fd.submit_update("w", "G", 5, keys,
                           {"a": np.ones((4, 4), np.int32)})
    ok = fd.submit("r", "G", 20)
    fd.pump()
    with pytest.raises(ValueError, match="monotonic"):
        bad.result(0)
    assert len(ok.result(0).keys) == 24
    assert fd.counters["failed"] == 1 and fd.counters["completed"] == 1
    return door_rec(fd, [bad, ok])


def test_failed_mutation_isolated():
    side_by_side(_failed_mutation)


def _cancelled(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    fut = fd.submit("t", "G", 20)
    assert fut.cancel()
    fd.pump()
    assert fut.cancelled()
    assert fd.counters["cancelled"] == 1 and fd.counters["completed"] == 0
    return door_rec(fd, [fut])


def test_cancelled_before_dispatch_skips_work():
    side_by_side(_cancelled)


def _stats(side):
    fd = side.serve.FrontDoor({"G": mk_store(side, "G", SEED)})
    futs = [fd.submit("t", "G", 20 + 10 * (i % 2)) for i in range(4)]
    fd.pump()
    s = fd.stats()
    lat = s["latency"]
    for stage in ("queue", "batch", "scan", "gather", "materialize",
                  "exec", "total"):
        assert stage in lat and {"n", "p50_ms", "p99_ms"} <= set(lat[stage])
    assert lat["total"]["n"] == 4 and lat["total"]["p99_ms"] >= 0.0
    assert lat["scan"]["n"] >= 1
    assert s["counters"]["completed"] == 4
    assert s["per_tenant"]["t"]["completed"] == 4
    assert s["queued"] == {"t": 0}
    assert "pool_pressure" in s and s["service"]["requests"] == 0
    return door_rec(fd, futs)


def test_stats_histograms_and_counters():
    side_by_side(_stats)


# -- concurrency stress against a serial replay -------------------------------

N_READERS, READS_EACH, RELEASES = 4, 20, 5


def _writer(fd, store, tenant, seed, published, applied, lock, errors):
    wrng = np.random.default_rng(seed)
    keys = [f"{store}-k{i}" for i in range(24)]
    try:
        for r in range(RELEASES):
            ts = 40 + r * 10
            table = {"a": wrng.integers(0, 99, (24, 4)).astype(np.int32)}
            fd.submit_update(tenant, store, ts, keys, table).result(60)
            with lock:
                applied[store].append((ts, keys, table))
                published[store].append(ts)
            if r == RELEASES // 2:
                fd.submit_compact(tenant, store, 10).result(60)
    except Exception as e:  # noqa: BLE001 — surfaced by the main thread
        errors.append(("writer", store, e))


def _reader(fd, idx, published, lock, reads, errors):
    rrng = np.random.default_rng(SEED + 100 + idx)
    tenant = f"reader-{idx}"
    try:
        for _ in range(READS_EACH):
            store_name = ("S1", "S2")[int(rrng.integers(0, 2))]
            with lock:
                opts = published[store_name]
                ts = opts[int(rrng.integers(0, len(opts)))]
            fut = fd.submit(tenant, store_name, int(ts),
                            priority=int(rrng.integers(0, 3)))
            reads.append((store_name, int(ts), fut))
    except Exception as e:  # noqa: BLE001
        errors.append(("reader", idx, e))


def test_stress_concurrent_matches_serial_oracle():
    """The port's door on its dispatcher thread with 2 writers and 4
    readers; every read against a serial replay of the applied mutations
    through the JAX package (the same seeds)."""
    stores = {"S1": mk_store(TORCH, "S1", SEED + 1),
              "S2": mk_store(TORCH, "S2", SEED + 2)}
    fd = tserve.FrontDoor(stores, config=tserve.FrontDoorConfig(
        max_queue_per_tenant=4096))
    published = {"S1": [10, 20, 30], "S2": [10, 20, 30]}
    applied = {"S1": [], "S2": []}
    lock = threading.Lock()
    errors, reads = [], []
    threads = [threading.Thread(target=_writer, args=(
        fd, s, f"writer-{s}", SEED + 10 + i, published, applied, lock,
        errors)) for i, s in enumerate(("S1", "S2"))]
    threads += [threading.Thread(target=_reader, args=(
        fd, i, published, lock, reads, errors)) for i in range(N_READERS)]
    with fd:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "deadlock: thread stuck"
    assert not errors, errors

    oracle = {"S1": mk_store(JAX, "S1", SEED + 1),
              "S2": mk_store(JAX, "S2", SEED + 2)}
    for name, muts in applied.items():
        for ts, keys, table in muts:
            oracle[name].update(ts, keys, table)
    assert all(len(m) == RELEASES for m in applied.values())
    assert len(reads) == N_READERS * READS_EACH
    for store_name, ts, fut in reads:
        got = fut.result(60)
        want = oracle[store_name].get_version(ts, fields=["a"])
        assert view_rec(got) == view_rec(want), \
            f"{store_name}@{ts}: concurrent result diverged from oracle"
    s = fd.stats()
    assert s["counters"]["failed"] == 0
    assert s["counters"]["completed"] == len(reads) + 2 * RELEASES + 2
    assert len(s["per_tenant"]) == N_READERS + 2


# -- property: admission and ordering policy ----------------------------------

def _property(side, stream):
    stores = {f"P{i}": mk_store(side, f"P{i}", SEED + i, n=4, releases=1)
              for i in range(3)}
    clk = FakeClock(0.0)
    fd = side.serve.FrontDoor(stores, config=side.serve.FrontDoorConfig(
        clock=clk, max_queue_per_tenant=4096))
    tickets = {}
    for seq0, (tenant, store, prio, dl) in enumerate(stream):
        fut = fd.submit(f"t{tenant}", f"P{store}", 10, priority=prio,
                        timeout=None if dl is None else float(dl))
        tickets[seq0 + 1] = (f"t{tenant}", f"P{store}", prio,
                             None if dl is None else float(dl), fut)
    clk.t = 1.0
    fd.pump()
    for seq, (tenant, store, prio, dl, fut) in tickets.items():
        assert fut.done(), f"request {seq} neither served nor shed"
        if dl is not None and dl < clk.t:
            assert isinstance(fut.exception(), side.serve.DeadlineExceeded)
        else:
            assert fut.exception() is None, fut.exception()
    by_tenant = {}
    for d in fd.dispatch_log:
        by_tenant.setdefault(d["tenant"], []).append(d["initiator"])
    for tenant, seqs in by_tenant.items():
        keys = [(-tickets[s][2],
                 tickets[s][3] if tickets[s][3] is not None
                 else float("inf"), s) for s in seqs]
        assert keys == sorted(keys), f"{tenant}: initiators out of order"
    for d in fd.dispatch_log:
        assert len({tickets[m][1] for m in d["members"]}) == 1
    return door_rec(fd, [t[-1] for t in tickets.values()])


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 2),
                          st.integers(-2, 5),
                          st.one_of(st.none(), st.integers(-5, 5))),
                min_size=1, max_size=32))
def test_property_shed_policy_and_priority_order(stream):
    side_by_side(_property, stream)


# -- tiered memory (tests/test_tiered_memory.py) ------------------------------

def mk_tiered(side, name, rng, n=120, releases=3):
    st_ = side.VersionedStore(name, [("a", 8, "int32")])
    keys = [f"{name}-k{i}" for i in range(n)]
    for v in range(1, releases + 1):
        st_.update(v * 10, keys,
                   {"a": rng.integers(0, 99, (n, 8)).astype(np.int32)})
    return st_


def req(side, *args):
    return side.serve.gestore_service.VersionRequest(*args)


def _eviction(side, tmp_path):
    rng = np.random.default_rng(0)
    stores = {"A": mk_tiered(side, "A", rng), "B": mk_tiered(side, "B", rng)}
    want_a = stores["A"].get_version(20, fields=["a"])
    want_b = stores["B"].get_version(30, fields=["a"])
    svc = side.serve.GeStoreService(stores, memory_budget_bytes=1,
                                    spill_root=str(tmp_path / side.name))
    got_a = svc.materialize([req(side, "A", 20, ("a",))])[0]
    got_b = svc.materialize([req(side, "B", 30, ("a",))])[0]
    assert svc.pool.stats["spills"] >= 1
    got_a2 = svc.materialize([req(side, "A", 20, ("a",))])[0]
    assert svc.pool.stats["reloads"] >= 1
    for got, want in ((got_a, want_a), (got_b, want_b), (got_a2, want_a)):
        assert view_rec(got) == view_rec(want)
    return ([view_rec(v) for v in (got_a, got_b, got_a2)],
            dict(svc.pool.stats), dict(svc.stats))


def test_eviction_then_query_identical(tmp_path):
    side_by_side(_eviction, tmp_path)


def _demotion(side):
    st_ = mk_tiered(side, "C", np.random.default_rng(0))
    want = st_.get_version(20, fields=["a"])
    svc = side.serve.GeStoreService({"C": st_}, memory_budget_bytes=1)
    svc.materialize([req(side, "C", 20, ("a",)), req(side, "C", 30, ("a",))])
    assert svc.pool.stats["demotions"] >= 1
    assert st_._superlog is None
    got = svc.materialize([req(side, "C", 20, ("a",))])[0]
    assert view_rec(got) == view_rec(want)
    return view_rec(got), dict(svc.pool.stats), st_.nbytes()


def test_device_to_host_demotion():
    side_by_side(_demotion)


def _no_budget(side):
    st_ = mk_tiered(side, "D", np.random.default_rng(0))
    svc = side.serve.GeStoreService({"D": st_})
    assert svc.pool is None
    views = svc.materialize([req(side, "D", 20, ("a",)),
                             req(side, "D", 30, ("a",))])
    assert st_._superlog is not None
    return [view_rec(v) for v in views], st_.nbytes()


def test_no_budget_means_no_eviction():
    side_by_side(_no_budget)


def _epoch_floor(side, tmp_path):
    pool = side.serve.TieredStorePool(
        {"E": mk_tiered(side, "E", np.random.default_rng(0))},
        budget_bytes=1, spill_root=str(tmp_path / side.name))
    pre = pool["E"].log_epoch
    assert pool.enforce() >= 1
    assert "E" in pool and len(pool) == 1
    post = pool["E"].log_epoch
    assert post > pre
    return pre, post, dict(pool.stats)


def test_epoch_floor_survives_spill(tmp_path):
    side_by_side(_epoch_floor, tmp_path)


def _accounting(side, tmp_path):
    pool = side.serve.TieredStorePool({}, budget_bytes=None,
                                      spill_root=str(tmp_path / side.name))
    assert pool.resident_bytes() == 0
    st_ = mk_tiered(side, "F", np.random.default_rng(0))
    pool.add("F", st_)
    assert pool.resident_bytes() == sum(st_.nbytes().values())
    assert pool.enforce() == 0
    assert set(pool.keys()) == {"F"}
    return pool.resident_bytes()


def test_pool_accounting_and_add(tmp_path):
    side_by_side(_accounting, tmp_path)


def _facade(side, tmp_path):
    reg = side.core.PluginRegistry()
    reg.register_parser(side.fasta(seq_width=16, desc_width=4))
    gs = side.GeStore(str(tmp_path / side.name / "gs"), reg)
    gs.add_release("up", 1, ">A x\nACDE\n>B y\nACDF\n", parser_name="fasta")
    svc = side.serve.GeStoreService(gs, memory_budget_bytes=1)
    v1 = svc.materialize([req(side, "up", 1)])[0]
    assert svc.pool.stats["spills"] >= 1
    assert "up" not in gs.stores
    gs.add_release("up", 2, ">A x\nACDE\n>C z\nGGGG\n", parser_name="fasta")
    v2 = svc.materialize([req(side, "up", 2)])[0]
    assert sorted(v2.keys) == [b"A", b"C"]
    assert sorted(v1.keys) == [b"A", b"B"]
    return view_rec(v1), view_rec(v2), dict(svc.pool.stats)


def test_gestore_facade_spill_then_mutate_serves_fresh_data(tmp_path):
    side_by_side(_facade, tmp_path)


def _replace_name(side):
    rng = np.random.default_rng(0)
    pool = side.serve.TieredStorePool({"H": mk_tiered(side, "H", rng)})
    high = pool["H"].log_epoch
    st2 = mk_tiered(side, "H", rng, releases=1)
    assert st2.log_epoch < high
    pool.add("H", st2)
    assert pool["H"].log_epoch > high
    return high, pool["H"].log_epoch


def test_pool_add_replacing_name_advances_epoch_floor():
    side_by_side(_replace_name)


def _empty_mapping(side, tmp_path):
    svc = side.serve.GeStoreService({}, memory_budget_bytes=1,
                                    spill_root=str(tmp_path / side.name))
    assert svc._stores is svc.pool
    svc.pool.add("Z", mk_tiered(side, "Z", np.random.default_rng(0)))
    v1 = svc.materialize([req(side, "Z", 20, ("a",))])[0]
    assert svc.pool.stats["spills"] >= 1
    v2 = svc.materialize([req(side, "Z", 20, ("a",))])[0]
    assert view_rec(v2) == view_rec(v1)
    return view_rec(v2), dict(svc.pool.stats)


def test_service_over_initially_empty_mapping_still_uses_pool(tmp_path):
    side_by_side(_empty_mapping, tmp_path)


def _sanitized(side, tmp_path):
    rng = np.random.default_rng(0)
    stores = {"a/b": mk_tiered(side, "a/b", rng),
              "a_b": mk_tiered(side, "a_b", rng)}
    wants = {n: s.get_version(20, fields=["a"]) for n, s in stores.items()}
    pool = side.serve.TieredStorePool(stores, budget_bytes=1,
                                      spill_root=str(tmp_path / side.name))
    assert pool.enforce() >= 2
    out = {}
    for name, want in wants.items():
        got = pool[name].get_version(20, fields=["a"])
        assert view_rec(got) == view_rec(want)
        out[name] = view_rec(got)
    return out


def test_spill_paths_never_collide_for_sanitized_names(tmp_path):
    side_by_side(_sanitized, tmp_path)


def _failed_reload(side, tmp_path):
    root = tmp_path / side.name
    pool = side.serve.TieredStorePool(
        {"K": mk_tiered(side, "K", np.random.default_rng(0))},
        budget_bytes=1, spill_root=str(root))
    assert pool.enforce() >= 1
    seg = sorted(glob.glob(str(root / "**" / "segments" / "**" / "*.npz"),
                           recursive=True))[0]
    with open(seg, "r+b") as f:
        f.truncate(8)
    for _ in range(2):
        with pytest.raises(side.segments.CorruptSegmentError):
            pool["K"]
    assert "K" in pool
    return dict(pool.stats)


def test_failed_reload_keeps_spill_record(tmp_path):
    side_by_side(_failed_reload, tmp_path)


def _nbytes(side):
    st_ = mk_tiered(side, "G", np.random.default_rng(0))
    host_only = st_.nbytes()
    assert host_only["device"] == 0
    st_.get_versions([10, 20], fields=["a"])
    with_dev = st_.nbytes()
    assert with_dev["device"] > 0
    st_.drop_superlog()
    assert st_.nbytes()["device"] == 0
    return host_only, with_dev


def test_store_nbytes_tracks_superlog():
    side_by_side(_nbytes)


@pytest.fixture
def chaos(monkeypatch):
    """Segment-read fault injection in both packages: with
    ``state["target"]`` a store name, every segment read under that
    store's directory raises ``state["exc"]`` (one of the side's own
    error type, by ``state["make"]``)."""
    state = {"target": None, "make": None, "hits": 0}
    for side in SIDES:
        real = side.segments.read_segment

        def wrapped(root, *args, _real=real, _side=side, **kwargs):
            t = state["target"]
            if t is not None and _side.segments.store_dir_name(t) in str(
                    root):
                state["hits"] += 1
                raise state["make"](_side)
            return _real(root, *args, **kwargs)

        monkeypatch.setattr(side.segments, "read_segment", wrapped)
    return state


def _corrupt(side):
    return side.segments.CorruptSegmentError("injected bit rot")


def _disk(side):
    return OSError("injected disk failure")


def _chaos_wave(side, tmp_path, chaos, make):
    rng = np.random.default_rng(0)
    stores = {"A": mk_tiered(side, "A", rng), "B": mk_tiered(side, "B", rng)}
    want_a = stores["A"].get_version(20, fields=["a"])
    want_b = stores["B"].get_version(20, fields=["a"])
    svc = side.serve.GeStoreService(stores, memory_budget_bytes=1,
                                    spill_root=str(tmp_path / side.name))
    assert svc.pool.enforce() >= 2
    side.obs.RECORDER.clear()
    chaos["target"], chaos["make"], chaos["hits"] = "A", make, 0
    items = [(req(side, "A", 20, ("a",)), Future()),
             (req(side, "B", 20, ("a",)), Future())]
    svc.serve_wave(items)
    with pytest.raises(type(make(side))):
        items[0][1].result(0)
    assert chaos["hits"] >= 1
    events = side.obs.RECORDER.dump()["events"]
    seg_errs = [e for e in events if e["kind"] == "segment_read_error"]
    assert seg_errs and "injected" in seg_errs[0]["error"]
    assert side.segments.store_dir_name("A") in seg_errs[0]["root"]
    wave_errs = [e for e in events if e["kind"] == "wave_error"]
    assert wave_errs and wave_errs[0]["store"] == "A"
    assert "injected" in wave_errs[0]["error"]
    got_b = items[1][1].result(0)
    assert view_rec(got_b) == view_rec(want_b)
    assert "A" in svc.pool
    chaos["target"] = None
    got_a = svc.materialize([req(side, "A", 20, ("a",))])[0]
    assert view_rec(got_a) == view_rec(want_a)
    return (view_rec(got_a), view_rec(got_b), dict(svc.pool.stats),
            [(e["kind"], e.get("store")) for e in events
             if e["kind"] in ("segment_read_error", "wave_error")])


@pytest.mark.parametrize("make", [_corrupt, _disk],
                         ids=["corrupt_segment", "os_error"])
def test_chaos_wave_fails_only_affected_group(tmp_path, chaos, make):
    side_by_side(_chaos_wave, tmp_path, chaos, make)


def _chaos_door(side, tmp_path, chaos):
    rng = np.random.default_rng(0)
    stores = {"A": mk_tiered(side, "A", rng), "B": mk_tiered(side, "B", rng)}
    want_a = stores["A"].get_version(30, fields=["a"])
    fd = side.serve.FrontDoor(stores, memory_budget_bytes=1,
                              spill_root=str(tmp_path / side.name))
    assert fd.service.pool.enforce() >= 2
    side.obs.RECORDER.clear()
    chaos["target"], chaos["make"] = "A", _corrupt
    doomed = fd.submit("tenant-a", "A", 30)
    fine = fd.submit("tenant-b", "B", 30)
    fd.pump()
    with pytest.raises(side.segments.CorruptSegmentError):
        doomed.result(0)
    events = side.obs.RECORDER.dump()["events"]
    seg_errs = [e for e in events if e["kind"] == "segment_read_error"]
    assert seg_errs and seg_errs[0].get("trace", "").startswith("req-")
    wave_errs = [e for e in events if e["kind"] == "wave_error"]
    assert wave_errs and wave_errs[0]["store"] == "A"
    assert wave_errs[0]["trace"] == seg_errs[0]["trace"]
    doomed_spans = [e for e in events if e["kind"] == "span"
                    and e["name"] == "read_wave"
                    and e["trace"] == seg_errs[0]["trace"]]
    assert doomed_spans and doomed_spans[0]["tenant"] == "tenant-a"
    assert len(fine.result(0).keys) == 120
    s = fd.stats()
    assert s["counters"]["failed"] == 1
    assert s["per_tenant"]["tenant-a"]["failed"] == 1
    assert s["per_tenant"]["tenant-b"]["completed"] == 1
    chaos["target"] = None
    healed = fd.submit("tenant-a", "A", 30)
    fd.pump()
    assert view_rec(healed.result(0)) == view_rec(want_a)
    assert fd.stats()["per_tenant"]["tenant-a"]["completed"] == 1
    return door_rec(fd, [doomed, fine, healed])


def test_chaos_frontdoor_keeps_serving_other_tenants(tmp_path, chaos):
    side_by_side(_chaos_door, tmp_path, chaos)


# -- the pool over sharded stores (tests/test_sharded_store.py) ---------------

SHARD_SCHEMA = [("seq", 6, "int32"), ("len", 1, "int32")]


def scripted_history(store, rng):
    """``tests/test_sharded_store.py``'s scripted history."""
    keys = [f"K{i:04d}" for i in range(30)]
    t1 = {"seq": rng.integers(0, 9, (30, 6)).astype(np.int32),
          "len": rng.integers(1, 9, (30, 1)).astype(np.int32)}
    store.update(10, keys, t1)
    keys2 = keys[:24] + ["N0", "N1", "N2"]
    t2 = {"seq": np.concatenate(
              [t1["seq"][:24], rng.integers(0, 9, (3, 6))]).astype(np.int32),
          "len": np.concatenate(
              [t1["len"][:24], rng.integers(1, 9, (3, 1))]).astype(np.int32),
          "ann": np.arange(27 * 2).reshape(27, 2)}
    t2["seq"][5] += 1
    store.update(20, keys2, t2)
    store.delete(25, ["K0003", "N1"])
    store.update(30, ["K0001", "Z9"],
                 {"seq": rng.integers(0, 9, (2, 6)).astype(np.int32),
                  "len": np.ones((2, 1), np.int32),
                  "ann": np.zeros((2, 2), np.int32)},
                 full_release=False)


def mk_pair(side, n_shards):
    a = side.VersionedStore("up", SHARD_SCHEMA)
    b = side.ShardedStore("up", SHARD_SCHEMA, n_shards=n_shards)
    scripted_history(a, np.random.default_rng(7))
    scripted_history(b, np.random.default_rng(7))
    return a, b


def _shard_by_shard(side, tmp_path):
    a, b = mk_pair(side, 3)
    want = a.get_version(20)
    pool = side.serve.TieredStorePool(
        {"up": b}, budget_bytes=sum(b.nbytes().values()) - 1,
        spill_root=str(tmp_path / side.name))
    assert pool.enforce() >= 1
    assert pool.stats["shard_spills"] >= 1
    assert pool.stats["spills"] == 0
    assert len(b.resident_shard_ids()) < 3
    got = pool["up"].get_version(20)
    assert view_rec(got) == view_rec(want)
    return view_rec(got), dict(pool.stats), b.resident_shard_ids()


def test_pool_spills_sharded_store_shard_by_shard(tmp_path):
    side_by_side(_shard_by_shard, tmp_path)


def _service_sharded(side, tmp_path):
    a, b = mk_pair(side, 2)
    svc = side.serve.GeStoreService({"up": b}, memory_budget_bytes=1,
                                    spill_root=str(tmp_path / side.name))
    got = svc.materialize([req(side, "up", 20, ("seq",)),
                           req(side, "up", 30, ("seq",))])
    want = a.get_versions([20, 30], fields=["seq"])
    for w, g in zip(want, got):
        assert view_rec(w) == view_rec(g)
    assert svc.pool.stats["shard_spills"] >= 1
    got2 = svc.materialize([req(side, "up", 20, ("seq",))])[0]
    assert got2.keys == want[0].keys
    return [view_rec(v) for v in got + [got2]], dict(svc.pool.stats)


def test_service_over_sharded_store(tmp_path):
    side_by_side(_service_sharded, tmp_path)


def _drops_facade(side, tmp_path):
    a, b = mk_pair(side, 2)
    want = a.get_version(30)
    pool = side.serve.TieredStorePool({"up": b}, budget_bytes=1,
                                      spill_root=str(tmp_path / side.name))
    assert pool.enforce() >= 2
    assert "up" not in pool._stores and "up" in pool
    re = pool["up"]
    assert isinstance(re, side.shard.ShardedStore)
    assert view_rec(re.get_version(30)) == view_rec(want)
    return view_rec(re.get_version(30)), dict(pool.stats)


def test_pool_drops_fully_spilled_facade(tmp_path):
    side_by_side(_drops_facade, tmp_path)


def _placed_accounting(side):
    _, b = mk_pair(side, 2)
    b.placement = side.placement.plan_placement(
        2, force="parallel", **({"devices": ["cpu"]} if side.dev else {}))
    b.get_versions([10, 20])
    assert b._placed is not None
    assert b.has_device_state()
    assert b.nbytes()["device"] > 0
    placed_bytes = b.nbytes()
    b.drop_superlog()
    assert b._placed is None and not b.has_device_state()
    b.get_versions([10, 20])
    placed = b._placed
    b.get_versions([25, 30])
    assert b._placed is placed
    b.update(99, ["K0000"], {"seq": np.ones((1, 6), np.int32),
                             "len": np.ones((1, 1), np.int32),
                             "ann": np.ones((1, 2), np.int32)},
             full_release=False)
    views = b.get_versions([99, 10])
    assert b._placed is not placed
    return placed_bytes["host"], [view_rec(v) for v in views]


def test_parallel_placed_cache_in_tiered_accounting():
    """As the JAX package's case, with the stacked copy counted in
    ``nbytes()["device"]`` (the device bytes differ by design: the
    JAX package's placement repins each shard's superlog; the port keeps
    the shards' own superlogs and adds the stacked copy)."""
    side_by_side(_placed_accounting)


def _pins_placement(side, tmp_path):
    a, b = mk_pair(side, 2)
    want = a.get_version(30)
    pool = side.serve.TieredStorePool({"up": b}, budget_bytes=1,
                                      spill_root=str(tmp_path / side.name),
                                      shard_placement="parallel")
    assert b.placement.parallel
    assert pool.enforce() >= 2
    re = pool["up"]
    assert isinstance(re, side.shard.ShardedStore) and re.placement.parallel
    got = re.get_version(30)
    assert view_rec(got) == view_rec(want)
    return view_rec(got), re.placement.mode, dict(pool.stats)


def test_pool_pins_placement_across_spill_reload(tmp_path):
    side_by_side(_pins_placement, tmp_path)


def _parallel_service(side):
    a, b = mk_pair(side, 2)
    svc = side.serve.GeStoreService({"up": b}, shard_placement="parallel")
    assert b.placement.parallel
    got = svc.materialize([req(side, "up", 20, None),
                           req(side, "up", 30, None)])
    for w, g in zip(a.get_versions([20, 30]), got):
        assert view_rec(w) == view_rec(g)
    return [view_rec(v) for v in got], b.placement.mode


def test_service_routes_through_parallel_placement():
    side_by_side(_parallel_service)


# -- the port's device rules ---------------------------------------------------

@pytest.mark.parametrize("n_shards", [0, 2], ids=["plain", "sharded"])
def test_spilled_cpu_store_reloads_on_the_cpu(tmp_path, n_shards):
    """A store spilled from the host comes back on the host: the port's
    ``open_any_store`` defaults to the card, so the pool passes the
    device it recorded at the spill. A sharded store's placement is
    planned over that device, stacked on the host."""
    _, b = mk_pair(TORCH, 2)
    st_ = b if n_shards else mk_tiered(TORCH, "up", np.random.default_rng(0))
    want = st_.get_version(30)
    pool = tserve.TieredStorePool({"up": st_}, budget_bytes=1,
                                  spill_root=str(tmp_path),
                                  shard_placement="parallel")
    assert pool.enforce() >= 1 and "up" not in pool._stores
    re = pool["up"]
    assert re is not st_ and re.device == torch.device("cpu")
    assert pool.stats["reloads"] == 1
    if n_shards:
        assert re.placement.mode == "stacked"
        assert re.shard(0).device == torch.device("cpu")
    assert view_rec(re.get_version(30)) == view_rec(want)


def test_served_views_are_frozen_numpy_and_stores_stay_writable():
    """Memoized views are read-only numpy arrays; the store's own host
    arrays and device tensors are never frozen."""
    st_ = mk_tiered(TORCH, "F", np.random.default_rng(0))
    svc = tserve.GeStoreService({"F": st_})
    v1, v2 = svc.materialize([req(TORCH, "F", 20, ("a",)),
                              req(TORCH, "F", 30, ("a",))])
    for v in (v1, v2):
        assert isinstance(v.values["a"], np.ndarray)
        assert not v.values["a"].flags.writeable
        assert not v.row_idx.flags.writeable
    assert st_.fields["a"].head_vals.flags.writeable
    st_.update(40, [f"F-k{i}" for i in range(4)],
               {"a": np.ones((4, 8), np.int32)}, full_release=False)
    v3 = svc.materialize([req(TORCH, "F", 40, ("a",)),
                          req(TORCH, "F", 20, ("a",))])
    assert (v3[0].values["a"][:4] == 1).all()
    assert view_rec(v3[1]) == view_rec(v1)
