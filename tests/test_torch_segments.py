"""The port's segmented persistence (``repro_torch.core.segments``) on the
CPU, and store directories shared with the JAX package.

The scenarios of ``tests/test_segmented_storage.py`` replay through the
port's ``VersionedStore`` on ``device="cpu"``: incremental saves, lazy and
eager loads, on-disk compaction, torn, missing and bit-flipped segments,
interrupted saves, and legacy snapshots. Then the two packages share
directories: one writes, the other opens, and the same history saved by
both gives the same bytes in every file.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import segments as jseg  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro_torch.core import segments  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.obs import RECORDER, REGISTRY, kerneltel  # noqa: E402

VersionedStore = tstore.VersionedStore
SCHEMA = [("a", 4, "int32"), ("b", 2, "float32"), ("c", 3, "int16"),
          ("d", 1, "int8")]
# the interop schema adds the unsigned fields (sign-extended lanes on the
# device, unsigned deltas on disk)
WIDE_SCHEMA = SCHEMA + [("u", 2, "uint16"), ("w", 1, "uint32")]


def mk_table(rng, n, schema=SCHEMA):
    t = {"a": rng.integers(0, 1 << 20, (n, 4)).astype(np.int32),
         "b": rng.normal(size=(n, 2)).astype(np.float32),
         "c": rng.integers(-300, 300, (n, 3)).astype(np.int16),
         "d": rng.integers(-5, 5, (n, 1)).astype(np.int8),
         "u": (65500 + rng.integers(0, 36, (n, 2))).astype(np.uint16),
         "w": rng.integers(0, 2**32, (n, 1)).astype(np.uint32)}
    return {f[0]: t[f[0]] for f in schema}


def new_store(schema=SCHEMA, name="t"):
    return VersionedStore(name, [tstore.FieldSchema(*f) for f in schema],
                          device="cpu")


def load(path, **kw):
    return VersionedStore.load(path, device="cpu", **kw)


def mk_store(rng, n_releases=4, n=30):
    st = new_store()
    keys = [f"k{i}" for i in range(n)]
    for v in range(1, n_releases + 1):
        st.update(v * 10, keys, mk_table(rng, n))
    return st


def same_view(a, b, what=""):
    assert (a.ts, a.keys) == (b.ts, b.keys), what
    assert np.array_equal(a.row_idx, b.row_idx), what
    assert list(a.values) == list(b.values), what
    for f in a.values:
        assert a.values[f].dtype == b.values[f].dtype, (what, f)
        assert a.values[f].tobytes() == b.values[f].tobytes(), (what, f)


def assert_equal_versions(a, b, ts_list):
    for t in ts_list:
        same_view(a.get_version(t), b.get_version(t), t)


def manifest(path):
    with open(os.path.join(path, segments.MANIFEST_NAME)) as f:
        return json.load(f)


def seg_index(path):
    return segments.read_segment_index(path, manifest(path))


def tree(path) -> dict:
    """Every file under ``path``: relative path -> bytes."""
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


# -- incremental save --------------------------------------------------------

def test_incremental_save_bytes_independent_of_history(rng, tmp_path):
    n = 60
    st = new_store()
    keys = [f"k{i}" for i in range(n)]
    st.update(10, keys, mk_table(rng, n))
    d = str(tmp_path / "store")
    assert st.save(d)["mode"] == "full"
    inc_bytes = []
    for v in range(2, 26):
        st.update(v * 10, keys, mk_table(rng, n))  # full churn
        stats = st.save(d)
        assert stats["mode"] == "incremental"
        assert stats["segments_written"] == len(SCHEMA)
        inc_bytes.append(stats["bytes_written"])
    assert max(inc_bytes[-3:]) < 2 * max(inc_bytes[:3])
    full = st.save(str(tmp_path / "rw"), force_full=True)
    assert full["mode"] == "full"
    assert full["bytes_written"] > 5 * max(inc_bytes)


def test_incremental_save_roundtrip(rng, tmp_path):
    st = mk_store(rng, n_releases=1)
    d = str(tmp_path / "s")
    st.save(d)
    keys = [f"k{i}" for i in range(30)]
    for v in (2, 3, 4):
        st.update(v * 10, keys[: 30 - v], mk_table(rng, 30 - v))  # + deletes
        st.save(d)
    st2 = load(d)
    assert st2.device == torch.device("cpu")
    assert_equal_versions(st, st2, [10, 20, 30, 40, 45])
    st2.update(50, keys[:5], {k: v[:5] for k, v in mk_table(rng, 30).items()},
               full_release=False)
    assert st2.save(d)["mode"] == "incremental"
    assert_equal_versions(st2, load(d), [10, 40, 50])
    assert st2._version_digests == load(d)._version_digests


def test_save_to_foreign_dir_is_full_rewrite(rng, tmp_path):
    st = mk_store(rng)
    other = mk_store(rng, n_releases=2)
    d = str(tmp_path / "s")
    other.save(d)
    assert st.save(d)["mode"] == "full"  # same name, divergent history
    assert_equal_versions(st, load(d), [10, 20, 30, 40])


# -- lazy load ---------------------------------------------------------------

def test_lazy_load_defers_segment_reads(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    st2 = load(d)
    assert all(len(c.log._pending) == 1 for c in st2.fields.values())
    v = st2.get_version(20, fields=["a"])
    assert len(st2.fields["a"].log._pending) == 0
    for f in ("b", "c", "d"):
        assert len(st2.fields[f].log._pending) == 1  # untouched
    same_view(v, st.get_version(20, fields=["a"]))


def test_lazy_load_update_change_detection(rng, tmp_path):
    st = mk_store(rng, n_releases=2)
    d = str(tmp_path / "s")
    st.save(d)
    st2 = load(d)
    head = st.get_version(20)
    info = st2.update(30, [k.decode() for k in head.keys],
                      {f: head.values[f] for f in st.fields})
    assert (info.n_new, info.n_updated, info.n_deleted) == (0, 0, 0)


def test_eager_load_matches_lazy(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    eager = load(d, lazy=False)
    assert all(not c.log._pending for c in eager.fields.values())
    assert_equal_versions(eager, load(d, lazy=True), [10, 20, 30, 40])
    assert_equal_versions(eager, st, [10, 20, 30, 40])


def test_load_defaults_to_the_card(rng, tmp_path, monkeypatch):
    st = mk_store(rng, n_releases=1)
    d = str(tmp_path / "s")
    st.save(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VersionedStore.load(d)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VersionedStore.load(d, lazy=False)


# -- compaction on disk ------------------------------------------------------

def test_compact_on_disk_roundtrip_and_retained_tail(rng, tmp_path):
    st = new_store()
    keys = [f"k{i}" for i in range(25)]
    d = str(tmp_path / "s")
    for v in range(1, 6):
        st.update(v * 10, keys, mk_table(rng, 25))
        st.save(d)
    st.delete(55, ["k3"])
    st.save(d)
    before = {t: st.get_version(t) for t in (30, 40, 50, 55)}
    stats = st.compact(30, path=d)
    assert stats["cells_dropped"] > 0
    assert stats["segments_retained"] > 0
    segs = seg_index(d)
    assert "base" in {s.kind for s in segs}
    assert all(s.ts0 >= 30 for s in segs)
    st2 = load(d)
    for t in (30, 40, 50, 55):
        same_view(st2.get_version(t), before[t], t)
    st2.update(60, keys[:4], {k: v[:4] for k, v in mk_table(rng, 25).items()},
               full_release=False)
    assert st2.save(d)["mode"] == "incremental"


def test_compact_refuses_divergent_directory(rng, tmp_path):
    keys = [f"k{i}" for i in range(25)]

    def mk(seed):
        st = new_store()
        r = np.random.default_rng(seed)
        for v in range(1, 6):
            st.update(v * 10, keys, mk_table(r, 25))
        return st

    a, b = mk(1), mk(2)
    d = str(tmp_path / "s")
    a.save(d)
    want = {t: b.get_version(t) for t in (30, 40, 50)}
    stats = b.compact(30, path=d)
    assert stats.get("segments_retained", 0) == 0
    re = load(d)
    for t in (30, 40, 50):
        same_view(re.get_version(t), want[t], t)


# -- crash safety ------------------------------------------------------------

def test_manifest_rejects_truncated_segment(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    p = os.path.join(d, seg_index(d)[0].path)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(segments.CorruptSegmentError, match="torn"):
        load(d)


def test_manifest_rejects_missing_segment(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    os.remove(os.path.join(d, seg_index(d)[0].path))
    with pytest.raises(segments.CorruptSegmentError, match="missing"):
        load(d)


def test_bitflip_rejected_on_first_read_and_recorded(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    p = os.path.join(d, seg_index(d)[0].path)
    with open(p, "rb") as f:
        blob = bytearray(f.read())
    blob[-8] ^= 0xFF
    with open(p, "wb") as f:
        f.write(bytes(blob))
    st2 = load(d)  # size unchanged: the lazy open succeeds
    errors = REGISTRY.counter("segments.read_errors").value
    with pytest.raises(segments.CorruptSegmentError, match="sha256"):
        st2.get_version(40)
    assert REGISTRY.counter("segments.read_errors").value == errors + 1
    ev = RECORDER.events("segment_read_error")[-1]
    assert ev["path"] == seg_index(d)[0].path and "sha256" in ev["error"]


def test_uncommitted_index_tail_is_ignored_and_reclaimed(rng, tmp_path,
                                                         monkeypatch):
    st = mk_store(rng, n_releases=2)
    d = str(tmp_path / "s")
    st.save(d)
    old_versions = [v.ts for v in st.versions]
    st.update(30, [f"k{i}" for i in range(30)], mk_table(rng, 30))
    monkeypatch.setattr(segments, "write_manifest",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError):
        st.save(d)
    monkeypatch.undo()
    st2 = load(d)
    assert [v.ts for v in st2.versions] == old_versions
    assert_equal_versions(st, st2, [10, 20])
    assert st.save(d)["mode"] == "incremental"
    assert_equal_versions(st, load(d), [10, 20, 30])


def test_interrupted_full_rewrite_keeps_previous_state(rng, tmp_path,
                                                       monkeypatch):
    st = mk_store(rng)
    d = str(tmp_path / "s")
    st.save(d)
    pre = {t: st.get_version(t) for t in (20, 40)}
    calls = {"n": 0}
    real = segments.write_segment

    def exploding(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full")
        return real(*a, **k)

    monkeypatch.setattr(segments, "write_segment", exploding)
    with pytest.raises(OSError):
        st.save(d, force_full=True)
    monkeypatch.undo()
    st2 = load(d)
    for t in (20, 40):
        same_view(st2.get_version(t), pre[t], t)


def test_interrupted_compact_keeps_previous_state_loadable(rng, tmp_path,
                                                           monkeypatch):
    st = new_store()
    keys = [f"k{i}" for i in range(20)]
    d = str(tmp_path / "s")
    for v in range(1, 6):
        st.update(v * 10, keys, mk_table(rng, 20))
        st.save(d)
    pre = {t: st.get_version(t) for t in (20, 50)}
    monkeypatch.setattr(segments, "write_manifest",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("boom")))
    with pytest.raises(OSError):
        st.compact(30, path=d)
    monkeypatch.undo()
    st2 = load(d)
    for t in (20, 50):
        same_view(st2.get_version(t), pre[t], t)


def test_store_and_field_dir_names_never_collide(rng, tmp_path):
    assert segments.store_dir_name("a/b") != segments.store_dir_name("a_b")
    assert segments.store_dir_name("plain-name.v2") == "plain-name.v2"
    for name in ("a/b", "plain-name.v2", "x y", ""):
        assert segments.store_dir_name(name) == jseg.store_dir_name(name)
    st = new_store([("a/b", 2, "int32"), ("a_b", 2, "int32")])
    tab = {"a/b": rng.integers(0, 99, (8, 2)).astype(np.int32),
           "a_b": rng.integers(100, 199, (8, 2)).astype(np.int32)}
    st.update(10, [f"k{i}" for i in range(8)], tab)
    d = str(tmp_path / "s")
    st.save(d)
    got = load(d).get_version(10)
    for f in ("a/b", "a_b"):
        assert np.array_equal(got.values[f], tab[f]), f


# -- legacy snapshots --------------------------------------------------------

def test_legacy_snapshot_loads_and_migrates(rng, tmp_path):
    st = mk_store(rng)
    d = str(tmp_path / "legacy")
    segments.write_legacy_snapshot(st, d)
    st2 = load(d)
    assert_equal_versions(st, st2, [10, 20, 30, 40])
    assert st2.save(d)["mode"] == "full"
    assert not os.path.exists(os.path.join(d, "cells.npz"))
    assert not os.path.exists(os.path.join(d, "meta.json"))
    assert_equal_versions(st, load(d), [10, 20, 30, 40])


def test_load_narrows_legacy_float64_schema(rng, tmp_path):
    st = new_store([("f", 2, "float32")])
    vals = rng.normal(size=(6, 2)).astype(np.float32)
    st.update(10, [f"k{i}" for i in range(6)], {"f": vals})
    d = str(tmp_path / "s")
    st.save(d)
    m = manifest(d)
    m["schema"][0]["dtype"] = "float64"  # as an old store would say
    with open(os.path.join(d, segments.MANIFEST_NAME), "w") as f:
        json.dump(m, f)
    re = load(d)
    assert re.schema["f"].dtype == "float32"
    assert np.array_equal(re.get_version(10).values["f"], vals)
    assert re.save(d)["mode"] == "full"
    assert manifest(d)["schema"][0]["dtype"] == "float32"


def test_save_reports_delta_codec_telemetry(rng, tmp_path):
    st = mk_store(rng, n_releases=1)
    kerneltel.KERNELS.clear()
    st.save(str(tmp_path / "s"))
    snap = kerneltel.KERNELS.snapshot()
    assert snap["delta_codec"]["calls"] == len(SCHEMA) + 1  # + EXISTS


# -- directories shared with the JAX package ---------------------------------

def twin_history(rng, jdir, tdir, *, n=24, releases=4):
    """The same releases through both packages, each saving after every
    release; returns (jax store, port store)."""
    j = jstore.VersionedStore("t", [jstore.FieldSchema(*f)
                                    for f in WIDE_SCHEMA])
    t = new_store(WIDE_SCHEMA)
    keys = [f"k{i}" for i in range(n)]
    for v in range(1, releases + 1):
        tab = mk_table(rng, n - v, WIDE_SCHEMA)
        for s, d in ((j, jdir), (t, tdir)):
            s.update(v * 10, keys[: n - v], tab)
            stats = s.save(d)
            assert stats["mode"] == ("full" if v == 1 else "incremental")
    j.delete(45, keys[:2])
    t.delete(45, keys[:2])
    return j, t


def answers(st, ts_list, pairs):
    """What a store answers, as plain comparable values: its history,
    digests and keys, views at ``ts_list`` and increments over ``pairs``."""
    out = [[v.__dict__ for v in st.versions], st._version_digests,
           st.n_rows, st.row_keys]
    for v in st.get_versions(ts_list):
        out.append((v.ts, v.keys, v.row_idx.tobytes(),
                    [(f, a.dtype.str, a.tobytes())
                     for f, a in v.values.items()]))
    for x in st.get_increments(pairs):
        out.append((x.t0, x.t1, x.keys, x.kind.tobytes(),
                    [(f, a.dtype.str, a.tobytes())
                     for f, a in x.values.items()]))
    return out


TS, PAIRS = [10, 25, 40, 45], [(10, 20), (-1, 45), (30, 45)]


def test_jax_written_directory_opens_in_the_port(rng, tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j, _ = twin_history(rng, jdir, tdir)
    j.save(jdir)
    want = answers(j, TS, PAIRS)
    assert answers(load(jdir), TS, PAIRS) == want
    assert answers(load(jdir, lazy=False), TS, PAIRS) == want
    # the port extends the JAX package's directory incrementally
    port = load(jdir)
    tab = mk_table(rng, 5, WIDE_SCHEMA)
    port.update(50, [f"k{i}" for i in range(5)], tab, full_release=False)
    assert port.save(jdir)["mode"] == "incremental"
    assert (answers(jstore.VersionedStore.load(jdir), [50], [(45, 50)])
            == answers(port, [50], [(45, 50)]))


def test_port_written_directory_opens_in_jax(rng, tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _, t = twin_history(rng, jdir, tdir)
    t.save(tdir)
    assert (answers(jstore.VersionedStore.load(tdir, lazy=False), TS, PAIRS)
            == answers(t, TS, PAIRS))
    t.compact(30, path=tdir)
    assert (answers(jstore.VersionedStore.load(tdir), [30, 45], [(30, 45)])
            == answers(t, [30, 45], [(30, 45)]))


def test_same_history_gives_identical_bytes(rng, tmp_path):
    """MANIFEST.json, the index lines and every segment file, byte for
    byte: after incremental saves, after compact(path=), after a full
    rewrite, and for the legacy snapshot."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    j, t = twin_history(rng, jdir, tdir)
    assert tree(jdir) == tree(tdir)
    assert j.save(jdir) == t.save(tdir)  # the delete, incrementally
    assert tree(jdir) == tree(tdir)
    assert j.compact(30, path=jdir) == t.compact(30, path=tdir)
    assert tree(jdir) == tree(tdir)
    jf, tf = str(tmp_path / "jf"), str(tmp_path / "tf")
    assert j.save(jf, force_full=True) == t.save(tf, force_full=True)
    assert tree(jf) == tree(tf)
    jl, tl = str(tmp_path / "jl"), str(tmp_path / "tl")
    jseg.write_legacy_snapshot(j, jl)
    segments.write_legacy_snapshot(t, tl)
    assert tree(jl) == tree(tl)
    names = {os.path.basename(p) for p in tree(tdir)}
    assert {"MANIFEST.json", "SEGMENTS.1.jsonl"} <= names
