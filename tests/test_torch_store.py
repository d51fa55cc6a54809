"""The port's VersionedStore against the JAX package's, on the CPU.

Each scenario replays the same operations through ``repro.core.store``
and ``repro_torch.core.store`` (``device="cpu"``) and requires identical
``VersionView``s, ``Increment``s, ``VersionInfo``s and ``_version_digests``
chains: with the superlog packed and unpacked (``GESTORE_PACKED_SUPERLOG``),
and on the cold (per-field) and warm (fused superlog) query paths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402

TS_MAX = 2**31 - 2
SCHEMA = [("a", 4, "int32"), ("b", 2, "float32"), ("c", 3, "uint16"),
          ("d", 1, "int16")]


def mk_table(rng, n):
    return {"a": rng.integers(-50, 50, (n, 4)).astype(np.int32),
            "b": rng.normal(size=(n, 2)).astype(np.float32),
            # near the top of uint16: sign-extended lanes, packed deltas
            "c": (65500 + rng.integers(0, 36, (n, 3))).astype(np.uint16),
            "d": rng.integers(-3, 3, (n, 1)).astype(np.int16)}


def same_arrays(a: dict, b: dict, what):
    assert list(a) == list(b), what
    for f in a:
        assert a[f].dtype == b[f].dtype, (what, f)
        assert a[f].shape == b[f].shape, (what, f)
        assert a[f].tobytes() == b[f].tobytes(), (what, f)


def same_view(a, b):
    assert (a.ts, a.keys) == (b.ts, b.keys)
    assert a.row_idx.dtype == b.row_idx.dtype
    assert np.array_equal(a.row_idx, b.row_idx)
    same_arrays(a.values, b.values, f"view {a.ts}")


def same_increment(a, b):
    assert (a.t0, a.t1, a.keys) == (b.t0, b.t1, b.keys)
    assert a.kind.dtype == b.kind.dtype and np.array_equal(a.kind, b.kind)
    assert np.array_equal(a.row_idx, b.row_idx)
    same_arrays(a.values, b.values, f"increment {(a.t0, a.t1)}")


class Twin:
    """One store in each package, driven by the same calls."""

    def __init__(self, schema=SCHEMA, name="t"):
        self.j = jstore.VersionedStore(
            name, [jstore.FieldSchema(*f) for f in schema])
        self.t = tstore.VersionedStore(
            name, [tstore.FieldSchema(*f) for f in schema], device="cpu")

    def do(self, method, *args, **kw):
        outs = []
        for s in (self.j, self.t):
            try:
                outs.append(("ok", getattr(s, method)(*args, **kw)))
            except Exception as e:  # both packages must fail alike
                outs.append(("err", type(e).__name__))
        assert outs[0][0] == outs[1][0], (method, outs)
        if outs[0][0] == "err":
            assert outs[0][1] == outs[1][1], (method, outs)
            return None
        return outs[0][1], outs[1][1]

    def same_state(self):
        assert ([v.__dict__ for v in self.j.versions]
                == [v.__dict__ for v in self.t.versions])
        assert self.j._version_digests == self.t._version_digests
        assert self.j._history_digest == self.t._history_digest
        assert (self.j.n_rows, self.j.row_keys) == (self.t.n_rows,
                                                    self.t.row_keys)
        assert self.j.log_epoch == self.t.log_epoch
        assert list(self.j.fields) == list(self.t.fields)

    def check_queries(self, ts_list, pairs, *, warm, **kw):
        if warm:
            self.j.superlog()
            self.t.superlog()
        a, b = self.do("get_versions", ts_list, **kw)
        for va, vb in zip(a, b):
            same_view(va, vb)
        if not warm:  # one ts at a time: the per-field cold path
            for ts in ts_list:
                va, vb = self.do("get_version", ts, **kw)
                same_view(va, vb)
        for sig in (None, ["a"]):
            a, b = self.do("get_increments", pairs, significant_fields=sig)
            for ia, ib in zip(a, b):
                same_increment(ia, ib)
            if not warm:
                for t0, t1 in pairs:
                    ia, ib = self.do("get_increment", t0, t1,
                                     significant_fields=sig)
                    same_increment(ia, ib)


def info_eq(a, b):
    assert a.__dict__ == b.__dict__


@pytest.fixture
def packed(request, monkeypatch):
    """GESTORE_PACKED_SUPERLOG for both packages: "1" keeps integer fields
    delta-packed on the device, "0" stores them plain. Tests where packing
    is not the point run unpacked: the JAX package's packed gather
    compiles an associative scan for every new log shape, which is slow
    on the CPU."""
    flag = getattr(request, "param", "0")
    monkeypatch.setenv("GESTORE_PACKED_SUPERLOG", flag)
    return flag


def history(tw, rng, n_versions=5, pool=40):
    keys = [f"K{i:03d}" for i in range(pool)]
    for v in range(n_versions):
        sub = sorted(rng.choice(keys, size=rng.integers(8, pool),
                                replace=False))
        info_eq(*tw.do("update", (v + 1) * 10, sub, mk_table(rng, len(sub))))
    return keys


@pytest.mark.parametrize("packed,warm", [("1", False), ("1", True),
                                         ("0", True)],
                         ids=["cold", "warm-packed", "warm-unpacked"],
                         indirect=["packed"])
def test_versions_and_increments_match_jax(packed, warm, rng):
    """(The cold path never builds the superlog, so packing is moot.)"""
    tw = Twin()
    keys = history(tw, rng)
    info_eq(*tw.do("delete", 55, [tw.t.row_keys[0], tw.t.row_keys[3]]))
    info_eq(*tw.do("update", 60, keys[:5], mk_table(rng, 5),
                   full_release=False, present_keys=keys[:12]))
    tw.same_state()
    qs = [-5, 5, 10, 15, 25, 40, 50, 55, 60, TS_MAX, TS_MAX + 10]
    pairs = [(10, 20), (10, 40), (20, 55), (-1, 10), (40, 60), (55, 60)]
    tw.check_queries(qs, pairs, warm=warm)
    for kw in (dict(include_deleted=True), dict(key_filter=r"^K0"),
               dict(key_filter=lambda k: k.endswith(b"7")),
               dict(fields=["c", "a"])):
        tw.check_queries([45, 55, 60], [(20, 60)], warm=warm, **kw)
    assert tw.j.nbytes() == tw.t.nbytes()  # same host and device bytes


def test_release_session_chunks_match_update(packed, rng):
    """ReleaseSession chunks in the port == whole update in the port ==
    the same chunks in the JAX package (cells, counts and digests)."""
    chunked, whole = Twin(), Twin()
    history(chunked, np.random.default_rng(1))
    history(whole, np.random.default_rng(1))
    keys = [f"K{i:03d}" for i in range(10, 50)]
    tbl = mk_table(rng, len(keys))
    ja, ta = chunked.j.begin_release(70), chunked.t.begin_release(70)
    for lo in range(0, len(keys), 7):
        part = {k: v[lo: lo + 7] for k, v in tbl.items()}
        assert ja.apply(keys[lo: lo + 7], part) == ta.apply(keys[lo: lo + 7],
                                                            part)
    info_eq(ja.finish(), ta.finish())
    info_eq(*whole.do("update", 70, keys, tbl))
    chunked.same_state()
    assert whole.t._version_digests == chunked.t._version_digests
    chunked.check_queries([60, 70], [(50, 70)], warm=True)
    with pytest.raises(RuntimeError):
        ta.finish()


def test_schema_evolution_and_rejected_releases(packed, rng):
    tw = Twin([("a", 2, "int32"), ("b", 1, "int16")])
    info_eq(*tw.do("update", 1, ["x", "y"], {"a": np.ones((2, 2), np.int32),
                                             "b": np.ones((2, 1), np.int16)}))
    info_eq(*tw.do("update", 2, ["x"], {
        "a": np.ones((1, 2), np.int32), "b": np.ones((1, 1), np.int16),
        "new_field": np.full((1, 3), 7, np.int64)}))  # narrowed to int32
    assert tw.t.schema["new_field"].dtype == "int32"
    # rejected: out of int16 range, an unknown wide dtype, a bad key, and
    # a non-monotonic timestamp leave both stores untouched
    assert tw.do("update", 3, ["x", "z"], {
        "a": np.full((2, 2), 7, np.int32), "c": np.ones((2, 1), np.int32),
        "b": np.full((2, 1), 70000, np.int32)}) is None
    assert tw.do("update", 3, ["x"], {"w": np.full((1, 1), 2**40)}) is None
    assert tw.do("update", 3, ["x", 3.5], {"a": np.ones((2, 2), np.int32)}) is None
    assert tw.do("update", 2, ["x"], {"a": np.ones((1, 2), np.int32)}) is None
    assert "c" not in tw.t.fields and tw.t.n_rows == 2
    tw.same_state()
    tw.check_queries([1, 2, 3], [(1, 2), (0, 3)], warm=False)
    tw.check_queries([1, 2, 3], [(1, 2), (0, 3)], warm=True)


def test_compaction_matches_jax(packed, rng):
    tw = Twin()
    keys = [f"k{i}" for i in range(25)]
    for v in range(1, 6):
        info_eq(*tw.do("update", v * 10, keys, mk_table(rng, 25)))
    info_eq(*tw.do("delete", 55, ["k3"]))
    a, b = tw.do("compact", 30)
    assert a == b and a["cells_dropped"] > 0
    tw.same_state()
    tw.check_queries([30, 40, 50, 55], [(30, 50), (40, 55)], warm=False)
    tw.check_queries([30, 40, 50, 55], [(30, 50), (40, 55)], warm=True)
    info_eq(*tw.do("update", 60, keys[5:10], mk_table(rng, 5),
                   full_release=False))
    tw.same_state()
    tw.check_queries([55, 60], [(30, 60)], warm=True)
    assert len(tw.t.get_version(60)) == 24  # k3 stays deleted


def test_empty_store_and_batches():
    tw = Twin([("a", 2, "int32")])
    assert tw.t.get_versions([]) == [] and tw.t.get_increments([]) == []
    tw.check_queries([1, TS_MAX], [(0, 1)], warm=False)
    tw.check_queries([1, TS_MAX], [(0, 1)], warm=True)
    info_eq(*tw.do("update", 1, ["x", "y"], {"a": np.ones((2, 2), np.int32)}))
    info_eq(*tw.do("delete", 2, ["x", "y"]))
    tw.check_queries([1, 2], [(1, 2)], warm=True, include_deleted=True)


def test_get_versions_is_one_batched_scan(rng, monkeypatch):
    """8 versions x F fields on a warm store = ONE kernel call."""
    tw = Twin()
    history(tw, rng, n_versions=4)
    tw.t.superlog()
    calls = []
    orig = tstore.kops.batched_masked_cumsum

    def counted(ts, tq):
        calls.append(tuple(tq.shape))
        return orig(ts, tq)

    monkeypatch.setattr(tstore.kops, "batched_masked_cumsum", counted)
    trace = {}
    views = tw.t.get_versions([10, 20, 30, 40, 15, 25, 35, TS_MAX],
                              trace=trace)
    assert len(views) == 8 and calls == [(8,)]
    assert set(trace) == {"scan", "gather", "materialize"}


def test_superlog_epochs_cancel_and_unported_persistence(rng):
    tw = Twin()
    history(tw, rng, n_versions=2)
    sl = tw.t.superlog()
    assert tw.t.superlog() is sl and tw.t.has_device_state()
    epoch = tw.t.log_epoch
    tw.do("update", 100, ["K000"], mk_table(rng, 1), full_release=False)
    assert tw.t.log_epoch > epoch and tw.t.superlog() is not sl
    tw.t.drop_superlog()
    assert not tw.t.has_device_state()
    with pytest.raises(tstore.OperationCancelled):
        tw.t.get_versions([10, 20], cancel=lambda: True)
    for call in (lambda: tw.t.save("x"), lambda: tstore.VersionedStore.load("x"),
                 lambda: tw.t.compact(10, path="x")):
        with pytest.raises(NotImplementedError, match="persistence"):
            call()
    tw.same_state()  # the refused compact(path=) changed nothing


def test_store_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tstore.VersionedStore("t", [tstore.FieldSchema("a", 1)])
    with pytest.raises(RuntimeError):
        tstore.VersionedStore("t", [], device="cuda")
    assert tstore.VersionedStore("t", [], device="cpu").device.type == "cpu"


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10**6), st.integers(2, 5), st.booleans())
def test_random_histories_match_jax(seed, n_versions, warm):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GESTORE_PACKED_SUPERLOG", "0")
        _random_history(seed, n_versions, warm)


def _random_history(seed, n_versions, warm):
    rng = np.random.default_rng(seed)
    tw = Twin()
    pool = [f"K{i}" for i in range(30)]
    ts = 0
    for _ in range(n_versions):
        ts += int(rng.integers(1, 20))
        op = rng.random()
        live = [k.decode() for k, alive in zip(
            tw.t.row_keys, tw.t.exists_at(TS_MAX)) if alive]
        if op < 0.15 and live:
            tw.do("delete", ts, list(rng.choice(live, size=1)))
        else:
            keys = sorted(rng.choice(pool, size=rng.integers(1, 25),
                                     replace=False))
            tw.do("update", ts, keys, mk_table(rng, len(keys)),
                  full_release=bool(op < 0.8))
        tw.same_state()
    qs = sorted({int(x) for x in rng.integers(-2, ts + 3, 5)})
    pairs = [(int(a), int(b)) for a, b in zip(qs[:-1], qs[1:])]
    tw.check_queries(qs, pairs or [(0, ts)], warm=warm)
