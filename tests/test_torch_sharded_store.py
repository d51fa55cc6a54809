"""The port's sharded store (``repro_torch.core.shard`` and
``core.placement``) on the CPU, against the JAX package's.

The store cases of ``tests/test_sharded_store.py`` replay through both
packages with ``device="cpu"``: scatter-gather equivalence for 1, 2 and 5
shards (views, increment kinds, ``VersionInfo``, per-shard digest chains),
serial against stacked and mesh placement, the release session, compaction,
spill and reload, torn saves and a foreign routing version. Then the two
packages share sharded directories: one writes, the other opens, and the
same history saved by both gives the same bytes in every file. The cases
that need the tiered pool, the service or ``GeStore`` wait for the slices
that port those.
"""
import dataclasses
import functools
import glob
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placement as jplace  # noqa: E402
from repro.core import shard as jshard  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.core import shard as tshard  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SPEC = [("seq", 6, "int32"), ("len", 1, "int32")]
SHARD_COUNTS = (1, 2, 5)
TS = [10, 20, 25, 30, 20]
PAIRS = [(10, 20), (20, 25), (10, 30), (25, 30), (10, 20)]
ONE = {"seq": np.ones((1, 6), np.int32), "len": np.ones((1, 1), np.int32),
       "ann": np.ones((1, 2), np.int32)}


def jschema():
    return [jstore.FieldSchema(*f) for f in SPEC]


def tschema():
    return [tstore.FieldSchema(*f) for f in SPEC]


def scripted_history(store, rng):
    """Releases exercising new/updated/deleted rows, schema evolution with
    int64 narrowing, patch semantics, and explicit deletes (the JAX
    package's own scripted history)."""
    keys = [f"K{i:04d}" for i in range(30)]
    t1 = {"seq": rng.integers(0, 9, (30, 6)).astype(np.int32),
          "len": rng.integers(1, 9, (30, 1)).astype(np.int32)}
    infos = [store.update(10, keys, t1)]
    keys2 = keys[:24] + ["N0", "N1", "N2"]
    t2 = {"seq": np.concatenate(
              [t1["seq"][:24], rng.integers(0, 9, (3, 6))]).astype(np.int32),
          "len": np.concatenate(
              [t1["len"][:24], rng.integers(1, 9, (3, 1))]).astype(np.int32),
          "ann": np.arange(27 * 2).reshape(27, 2)}  # int64 -> int32 narrowing
    t2["seq"][5] += 1
    infos.append(store.update(20, keys2, t2))
    infos.append(store.delete(25, ["K0003", "N1"]))
    infos.append(store.update(
        30, ["K0001", "Z9"],
        {"seq": rng.integers(0, 9, (2, 6)).astype(np.int32),
         "len": np.ones((2, 1), np.int32),
         "ann": np.zeros((2, 2), np.int32)},
        full_release=False))
    return infos


def port_sharded(n_shards, **kw):
    st = tshard.ShardedStore("up", tschema(), n_shards=n_shards,
                             device="cpu", **kw)
    return st, scripted_history(st, np.random.default_rng(7))


def port_plain():
    st = tstore.VersionedStore("up", tschema(), device="cpu")
    scripted_history(st, np.random.default_rng(7))
    return st


def jax_sharded(n_shards):
    st = jshard.ShardedStore("up", jschema(), n_shards=n_shards)
    return st, scripted_history(st, np.random.default_rng(7))


def answers(st):
    """Every query of the JAX package's equivalence cases."""
    return {
        "views": st.get_versions(TS),
        "deleted": st.get_versions(TS, include_deleted=True),
        "filtered": st.get_versions([20, 30], fields=["seq"],
                                    key_filter=b"K000"),
        "incs": st.get_increments(PAIRS, significant_fields=["seq"]),
        "keys_only": [st.get_increment(10, 30, fields=[])],
    }


@functools.lru_cache(maxsize=None)
def jax_reference(n_shards):
    """The JAX sharded store's answers, infos and per-shard digest chains
    (built once per shard count: JAX compiles per shape)."""
    st, infos = jax_sharded(n_shards)
    return (answers(st), [dataclasses.asdict(i) for i in infos],
            [list(st.shard(s)._version_digests) for s in range(n_shards)])


def same_rows(a, b, what=""):
    assert a.keys == b.keys, what
    assert a.row_idx.dtype == b.row_idx.dtype, what
    assert np.array_equal(a.row_idx, b.row_idx), what
    assert list(a.values) == list(b.values), what
    for f in a.values:
        assert a.values[f].dtype == b.values[f].dtype, (what, f)
        assert a.values[f].tobytes() == b.values[f].tobytes(), (what, f)


def same_view(a, b, what=""):
    assert a.ts == b.ts, what
    same_rows(a, b, what)


def same_inc(a, b, what=""):
    assert (a.t0, a.t1) == (b.t0, b.t1), what
    assert a.kind.dtype == b.kind.dtype, what
    assert np.array_equal(a.kind, b.kind), what
    same_rows(a, b, what)


def same_answers(a, b):
    for key in ("views", "deleted", "filtered"):
        for x, y in zip(a[key], b[key], strict=True):
            same_view(x, y, key)
    for key in ("incs", "keys_only"):
        for x, y in zip(a[key], b[key], strict=True):
            same_inc(x, y, key)


def tree(path) -> dict:
    """Every file under ``path``: relative path -> bytes."""
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


# -- equivalence --------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_scatter_gather_matches_jax_and_unsharded(n_shards):
    st, infos = port_sharded(n_shards)
    got = answers(st)
    want, jinfos, jdigests = jax_reference(n_shards)
    same_answers(got, want)
    same_answers(got, answers(port_plain()))
    assert [dataclasses.asdict(i) for i in infos] == jinfos
    assert [dataclasses.asdict(v) for v in st.versions] == jinfos
    assert [st.shard(s)._version_digests
            for s in range(n_shards)] == jdigests
    # every key lives on the shard the JAX package routes it to
    assert st._shard_of == list(jshard.route_keys(st.row_keys, n_shards))
    assert st.log_epoch == sum(st.shard(s).log_epoch
                               for s in range(n_shards))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_parallel_placement_byte_identical(n_shards):
    """Forced-parallel (stacked on one device) and a hand-built mesh over
    two CPU devices (``cpu`` and ``cpu:0`` are distinct devices to the
    placement, so the shards split into two device blocks) answer exactly
    as the serial loop and as the JAX package."""
    want = jax_reference(n_shards)[0]
    serial, _ = port_sharded(n_shards)
    serial.placement = tplace.plan_placement(n_shards, devices=["cpu"],
                                              force="serial")
    same_answers(answers(serial), want)
    stacked, _ = port_sharded(n_shards)
    stacked.placement = tplace.plan_placement(n_shards, devices=["cpu"],
                                               force="parallel")
    assert stacked.placement.mode == ("stacked" if n_shards > 1
                                      else "serial")
    same_answers(answers(stacked), want)
    mesh, _ = port_sharded(n_shards)
    devs = tuple(torch.device("cpu", 0) if s % 2 else torch.device("cpu")
                 for s in range(n_shards))
    mesh.placement = tplace.ShardPlacement("mesh", devs)
    same_answers(answers(mesh), want)
    assert len(mesh._placed._blocks) == min(n_shards, 2)
    assert [ids for _d, ids, _t, _b in mesh._placed._blocks] == (
        [list(range(0, n_shards, 2)), list(range(1, n_shards, 2))]
        [: min(n_shards, 2)])
    if n_shards > 1:
        assert stacked._placed is not None
        assert stacked._placed.nbytes() == mesh._placed.nbytes()


def test_plan_placement_modes():
    """Auto plan: serial below 2 shards or with too few devices; forced
    parallel degrades to stacked; mesh with a device per shard. Without
    a card the CUDA device list is empty."""
    plan = tplace.plan_placement
    assert plan(1).mode == "serial"
    assert plan(5, devices=[]).mode == "serial"
    assert plan(5, devices=[], force="parallel").mode == "stacked"
    assert plan(5, devices=["cpu"] * 5, force="serial").mode == "serial"
    mesh = plan(2, devices=["cpu", "cpu", "cpu"])
    assert mesh.mode == "mesh" and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.device_for(1) == torch.device("cpu")
    assert plan(2, devices=["cpu"]).device_for(0) is None
    # the JAX package decides alike on one device
    for n, force in ((1, None), (5, None), (5, "parallel"), (5, "serial")):
        assert plan(n, devices=["cpu"], force=force).mode == \
            jplace.plan_placement(n, force=force).mode


def test_env_override_and_cpu_store_plan(monkeypatch):
    st, _ = port_sharded(2)
    assert st.placement.mode == "serial"  # one CPU device for 2 shards
    monkeypatch.setenv(tplace.PARALLEL_ENV, "1")
    st2, _ = port_sharded(2)
    assert st2.placement.mode == "stacked"
    same_answers(answers(st2), jax_reference(2)[0])


# -- release session ----------------------------------------------------------

@pytest.mark.parametrize("parallel", [False, True])
def test_release_session_matches_update(parallel):
    """Chunked wave releases commit the same cells, counts and per-shard
    digest chains as a whole-file ``update`` of the concatenated chunks,
    and as the JAX package's session."""
    rng = np.random.default_rng(11)
    keys = [f"P{i:05d}" for i in range(40)]
    rel = [{"seq": rng.integers(0, 9, (40, 6)).astype(np.int32),
            "len": rng.integers(1, 9, (40, 1)).astype(np.int32)}
           for _ in range(2)]
    rel[1]["seq"][::3] = rel[0]["seq"][::3]
    keep = np.arange(3, 40)  # the second release drops three keys

    def chunked(st, parallel_):
        infos = []
        for ts, r, ks in ((10, rel[0], np.arange(40)), (20, rel[1], keep)):
            sess = st.begin_release(ts, parallel=parallel_)
            for part in np.array_split(ks, 4):
                sess.apply([keys[i] for i in part],
                           {f: v[part] for f, v in r.items()})
            infos.append(sess.finish())
        return infos

    port = tshard.ShardedStore("s", tschema(), n_shards=3, device="cpu")
    whole = tshard.ShardedStore("s", tschema(), n_shards=3, device="cpu")
    jax = jshard.ShardedStore("s", jschema(), n_shards=3)
    infos = chunked(port, parallel)
    jinfos = chunked(jax, False)
    winfos = [whole.update(10, keys, rel[0]),
              whole.update(20, [keys[i] for i in keep],
                           {f: v[keep] for f, v in rel[1].items()})]
    as_dicts = lambda xs: [dataclasses.asdict(x) for x in xs]  # noqa: E731
    assert as_dicts(infos) == as_dicts(winfos) == as_dicts(jinfos)
    for s in range(3):
        assert port.shard(s)._version_digests == \
            whole.shard(s)._version_digests == jax.shard(s)._version_digests
    for a, b in zip(port.get_versions([10, 20]), whole.get_versions([10, 20])):
        same_view(a, b)
    with pytest.raises(ValueError, match="monotonic"):
        port.begin_release(20)


# -- compaction, persistence --------------------------------------------------

def test_compact_matches_jax(tmp_path):
    st, _ = port_sharded(2)
    js, _ = jax_sharded(2)
    st.save(str(tmp_path / "t"))
    js.save(str(tmp_path / "j"))
    got = st.compact(22, path=str(tmp_path / "t"))
    want = js.compact(22, path=str(tmp_path / "j"))
    assert got == want
    assert [dataclasses.asdict(v) for v in st.versions] == \
        [dataclasses.asdict(v) for v in js.versions]
    plain = port_plain()
    plain.compact(22)
    for t in (25, 30):
        same_view(st.get_version(t), plain.get_version(t), t)
    a, b = tree(str(tmp_path / "t")), tree(str(tmp_path / "j"))
    assert sorted(a) == sorted(b)
    assert all(a[k] == b[k] for k in a)
    back = tshard.ShardedStore.load(str(tmp_path / "t"), device="cpu")
    for t in (25, 30):
        same_view(back.get_version(t), plain.get_version(t), t)


def test_save_load_round_trip_and_incremental(tmp_path):
    st, _ = port_sharded(3)
    plain = port_plain()
    d = str(tmp_path / "up")
    assert st.save(d)["mode"] == "full"
    back = tshard.ShardedStore.load(d, device="cpu")
    for t in (10, 20, 25, 30):
        same_view(plain.get_version(t), back.get_version(t), t)
    same_inc(plain.get_increment(10, 30), back.get_increment(10, 30))
    back.update(40, ["K0001"], ONE, full_release=False)
    stats = back.save(d)
    assert stats["mode"] == "incremental" and stats["n_shards"] == 3
    plain.update(40, ["K0001"], ONE, full_release=False)
    again = tshard.open_any_store(d, device="cpu")
    assert isinstance(again, tshard.ShardedStore)
    same_view(plain.get_version(40), again.get_version(40))
    one = str(tmp_path / "plain")
    plain.save(one)
    assert isinstance(tshard.open_any_store(one, device="cpu"),
                      tstore.VersionedStore)


def test_directories_open_in_both_packages(tmp_path):
    """A sharded directory the JAX package wrote opens in the port and
    answers identically, and the other way round; the same history saved
    by both gives byte-identical manifests and shard trees, after an
    incremental save too."""
    for n in SHARD_COUNTS:
        st, _ = port_sharded(n)
        js, _ = jax_sharded(n)
        pd, jd = str(tmp_path / f"p{n}"), str(tmp_path / f"j{n}")
        assert st.save(pd) == js.save(jd)
        st.update(40, ["K0002", "NEW"], {f: np.repeat(v, 2, axis=0)
                                         for f, v in ONE.items()},
                  full_release=False)
        js.update(40, ["K0002", "NEW"], {f: np.repeat(v, 2, axis=0)
                                         for f, v in ONE.items()},
                  full_release=False)
        assert st.save(pd) == js.save(jd)
        a, b = tree(pd), tree(jd)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k] == b[k], (n, k)
        want = answers(js)
        same_answers(answers(tshard.ShardedStore.load(jd, device="cpu")),
                     want)
        same_answers(answers(jshard.ShardedStore.load(pd)), want)
        assert set(glob.glob(os.path.join(pd, "shard-*"))) == {
            os.path.join(pd, f"shard-{i:05d}") for i in range(n)}


def test_load_rejects_foreign_routing(tmp_path):
    st, _ = port_sharded(2)
    d = str(tmp_path / "up")
    st.save(d)
    p = os.path.join(d, tshard.SHARD_MANIFEST_NAME)
    with open(p) as f:
        man = json.load(f)
    man["routing"] = "some-other-hash-v9"
    with open(p, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="routing"):
        tshard.ShardedStore.load(d, device="cpu")
    assert tshard.read_shard_manifest(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tshard.ShardedStore.load(str(tmp_path), device="cpu")


def test_torn_save_recovers_on_load(tmp_path):
    """save() commits shard dirs first, the shard manifest last: a crash
    in between (the pre-release manifest restored) leaves the store
    loadable, with the torn release's committed keys adopted."""
    st, _ = port_sharded(2)
    d = str(tmp_path / "up")
    st.save(d)
    man = os.path.join(d, tshard.SHARD_MANIFEST_NAME)
    shutil.copy(man, str(tmp_path / "man.bak"))
    st.update(60, ["TORNKEY"], ONE, full_release=False)
    st.save(d)
    shutil.copy(str(tmp_path / "man.bak"), man)  # crash before the manifest
    back = tshard.ShardedStore.load(d, device="cpu")
    assert b"TORNKEY" in back.key_to_row
    assert b"TORNKEY" in back.get_version(60).keys
    assert back._saved_epoch is None  # save-dirty: the next spill commits
    assert back.spill_shard() is not None
    again = tshard.ShardedStore.load(d, device="cpu")
    assert b"TORNKEY" in again.key_to_row
    # the JAX package recovers the same directory the same way
    shutil.copy(str(tmp_path / "man.bak"), man)
    jback = jshard.ShardedStore.load(d)
    back = tshard.ShardedStore.load(d, device="cpu")
    assert jback.row_keys == back.row_keys


# -- residency, epochs, guards ------------------------------------------------

def test_shard_spill_partial_residency(tmp_path):
    st, _ = port_sharded(3)
    plain = port_plain()
    with pytest.raises(RuntimeError, match="directory"):
        st.spill_shard()
    st.save(str(tmp_path / "up"))
    e0 = st.log_epoch
    freed = st.spill_shard()
    assert freed and freed > 0
    assert len(st.resident_shard_ids()) == 2
    assert st.log_epoch >= e0
    same_view(plain.get_version(20), st.get_version(20))  # lazy reload
    assert len(st.resident_shard_ids()) == 3
    assert st.shard(0).device == torch.device("cpu")
    while st.spill_shard() is not None:
        pass
    assert st.resident_shard_ids() == []
    assert st.nbytes() == {"host": 0, "device": 0}
    same_view(plain.get_version(30), st.get_version(30))


def test_parallel_path_survives_spill_and_accounts_device_bytes(tmp_path):
    """The stacked copy is keyed on the per-shard epoch tuple, which a
    spill freezes and a reload floors: answers stay identical with no
    restack skew; nbytes counts the stacked copy and drop_superlog frees
    it. Its device bytes equal the JAX package's stacked copy."""
    st, _ = port_sharded(3)
    st.placement = tplace.plan_placement(3, devices=["cpu"], force="parallel")
    js, _ = jax_sharded(3)
    js.placement = jplace.plan_placement(3, force="parallel")
    plain = port_plain()
    for a, b in zip(plain.get_versions([10, 20]), st.get_versions([10, 20])):
        same_view(a, b)
    js.get_versions([10, 20])
    assert st._placed.nbytes() == js._placed.nbytes()
    assert st.has_device_state() and st.nbytes()["device"] > 0
    st.save(str(tmp_path / "up"))
    assert st.spill_shard() is not None
    for a, b in zip(plain.get_versions([20, 30]), st.get_versions([20, 30])):
        same_view(a, b)
    same_inc(plain.get_increment(10, 30), st.get_increment(10, 30))
    st.drop_superlog()
    assert st._placed is None and not st.has_device_state()
    st.get_versions([10, 20])
    placed = st._placed
    st.get_versions([25, 30])
    assert st._placed is placed
    st.update(99, ["K0000"], ONE, full_release=False)
    st.get_versions([99, 10])
    assert st._placed is not placed


def test_epoch_monotone_and_floorable():
    st, _ = port_sharded(2)
    e0 = st.log_epoch
    st.update(50, ["K0000"], ONE, full_release=False)
    e1 = st.log_epoch
    assert e1 > e0
    st._log_epoch = e1 + 100  # the pool's floor assignment
    assert st.log_epoch == e1 + 100


def test_guards_fire_before_any_shard_mutates(tmp_path):
    st, _ = port_sharded(2)
    with pytest.raises(ValueError):
        st.update(30, ["X"], {"seq": np.zeros((1, 6), np.int32),
                              "len": np.zeros((1, 1), np.int32)})
    epoch = st.log_epoch
    with pytest.raises(KeyError):
        st.delete(50, ["NEVER-SEEN"])
    assert st.log_epoch == epoch
    with pytest.raises(ValueError, match="int32 range"):
        st.update(99, ["K0000"], {"newf": np.ones((1, 1), np.int32),
                                  "len": np.full((1, 1), 2**40, np.int64)},
                  full_release=False)
    with pytest.raises(TypeError):  # unconvertible key
        st.update(99, ["K0000", 3.5],
                  {f: np.repeat(v, 2, axis=0) for f, v in ONE.items()},
                  full_release=False)
    assert "newf" not in st.schema
    assert all("newf" not in st.shard(s).fields for s in range(2))
    # a crash-skewed shard that is spilled still trips the floor first
    st.save(str(tmp_path / "up"))
    st._shards[0].update(77, [], {}, full_release=False)
    st.spill_shard(0)
    rows = list(st.row_keys)
    with pytest.raises(ValueError, match="monotonic"):
        st.update(77, ["BRANDNEW"], ONE, full_release=False)
    assert st.row_keys == rows
    assert st.shard(1).last_ts != 77


def test_corrupt_shard_fails_before_any_mutation(tmp_path):
    st, _ = port_sharded(3)
    st.save(str(tmp_path / "up"))
    while st.spill_shard() is not None:
        pass
    seg = sorted(glob.glob(str(tmp_path / "up" / "shard-00001" / "segments"
                               / "**" / "*.npz"), recursive=True))[0]
    with open(seg, "r+b") as f:
        f.truncate(8)  # torn write
    before = list(st.versions)
    with pytest.raises(tseg.CorruptSegmentError):
        st.update(99, ["K0000"], ONE, full_release=False)
    assert st.versions == before
    for s in st.resident_shard_ids():
        assert st._shards[s].last_ts < 99


def test_spills_keep_directories_loadable(tmp_path):
    """A spill commits a manifest consistent with every shard directory;
    saving a partly spilled store to a new directory writes every shard
    there; a spill retargeted to a fresh root saves there first."""
    st, _ = port_sharded(3)
    plain = port_plain()
    st.save(str(tmp_path / "A"))
    st.update(50, ["NEWKEY"], ONE, full_release=False)  # not flushed yet
    plain.update(50, ["NEWKEY"], ONE, full_release=False)
    assert st.spill_shard() is not None
    back = tshard.ShardedStore.load(str(tmp_path / "A"), device="cpu")
    same_view(plain.get_version(50), back.get_version(50))
    st.save(str(tmp_path / "B"))
    same_view(plain.get_version(50), tshard.ShardedStore.load(
        str(tmp_path / "B"), device="cpu").get_version(50))
    c = tshard.ShardedStore.load(str(tmp_path / "B"), device="cpu")
    assert c.spill_shard(root=str(tmp_path / "C")) is not None
    same_view(plain.get_version(50), c.get_version(50))


# -- devices ------------------------------------------------------------------

def test_no_card_means_no_store(monkeypatch, tmp_path):
    """Without ``device=`` a sharded store and its load want the CUDA
    card, and raise when there is none; routing honours the store's
    device (here the CPU, through the plain version)."""
    st, _ = port_sharded(2)
    d = str(tmp_path / "up")
    st.save(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tshard.ShardedStore("x", tschema(), n_shards=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tshard.ShardedStore.load(d)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tshard.open_any_store(d)
    before = {k: fn.launches for k, fn in tops.KERNELS.items()}
    back = tshard.ShardedStore.load(d, device="cpu")
    assert back.device == torch.device("cpu")
    assert all(back.shard(s).device == torch.device("cpu") for s in range(2))
    back.update(40, ["K0000", "FRESH"],
                {f: np.repeat(v, 2, axis=0) for f, v in ONE.items()},
                full_release=False)
    assert {k: fn.launches for k, fn in tops.KERNELS.items()} == before
    with pytest.raises(ValueError):
        tshard.ShardedStore("x", tschema(), n_shards=0, device="cpu")
