"""A store carried from the JAX package into the port by ``from_state``.

The test reads a ``repro`` store's consolidated logs and history out
itself (the port never imports ``repro``), hands them to
``repro_torch``'s ``VersionedStore.from_state``, and requires identical
answers, then an identical digest after one more identical ``update`` in
both packages: the port's lazily rebuilt heads and its fingerprints
decide which cells that update appends, and the digest hashes both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import store as jstore  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from test_torch_store import (SCHEMA, Twin, info_eq, mk_table,  # noqa: E402
                              same_increment, same_view)

TS_MAX = 2**31 - 2


@pytest.fixture(autouse=True)
def unpacked(monkeypatch):
    """Plain superlog fields: packing has its own parity tests
    (test_torch_store.py), and the JAX package's packed gather compiles
    an associative scan for every new log shape."""
    monkeypatch.setenv("GESTORE_PACKED_SUPERLOG", "0")


def jax_state(js: jstore.VersionedStore) -> dict:
    """The state dict of a JAX-package store, read out field by field."""
    logs = {}
    named = [(n, c.log) for n, c in js.fields.items()]
    for name, log in named + [("__exists__", js.exists_log)]:
        vals, tss, ptr = log.csr(js.n_rows)
        logs[name] = {"vals": vals, "ts": tss, "rows": log._csr[2],
                      "ptr": np.asarray(ptr)}
    return {"name": js.name,
            "schema": [dataclasses.asdict(f) for f in js.schema.values()],
            "row_keys": list(js.row_keys), "logs": logs,
            "versions": [dataclasses.asdict(v) for v in js.versions],
            "version_digests": list(js._version_digests),
            "history_digest": js._history_digest}


def jax_history(rng, *, compact: bool):
    js = jstore.VersionedStore("carried", [jstore.FieldSchema(*f)
                                           for f in SCHEMA])
    keys = [f"E{i:03d}" for i in range(40)]
    for v in range(1, 6):
        sub = sorted(rng.choice(keys, size=int(rng.integers(15, 40)),
                                replace=False))
        js.update(v * 10, sub, mk_table(rng, len(sub)))
    js.delete(55, [js.row_keys[1]])
    if compact:
        js.compact(20)
    return js, keys


def answers_match(js, ts_, qs, pairs):
    for warm in (False, True):
        if warm:
            js.superlog()
            ts_.superlog()
        for a, b in zip(js.get_versions(qs), ts_.get_versions(qs)):
            same_view(a, b)
        for a, b in zip(js.get_increments(pairs, significant_fields=["a"]),
                        ts_.get_increments(pairs, significant_fields=["a"])):
            same_increment(a, b)


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compacted"])
def test_from_state_answers_and_digests_match_jax(compact, rng):
    js, keys = jax_history(rng, compact=compact)
    ts_ = tstore.VersionedStore.from_state(jax_state(js), device="cpu")
    assert ts_._version_digests == js._version_digests
    assert [v.__dict__ for v in ts_.versions] == [v.__dict__
                                                  for v in js.versions]
    qs = [5, 20, 35, 50, 55, TS_MAX]
    answers_match(js, ts_, qs, [(20, 40), (30, 55), (-1, 55)])
    # one more identical release: unchanged rows (head fingerprints equal),
    # changed rows, a new key, and absent keys that get tombstoned
    cur = js.get_version(TS_MAX)
    sub = [k.decode() for k in cur.keys[:-3]] + ["E900"]
    tbl = {f: np.concatenate([cur.values[f][:-3],
                              mk_table(rng, 1)[f]]) for f in cur.values}
    tbl["a"][::4] += 1
    tbl["c"][1::5] -= 1
    info_eq(js.update(70, sub, tbl), ts_.update(70, sub, tbl))
    assert ts_._version_digests == js._version_digests
    assert ts_._history_digest == js._history_digest
    for name in js.fields:  # the rebuilt heads equal the JAX package's
        assert np.array_equal(ts_.fields[name].head_fp[: ts_.n_rows],
                              js.fields[name].head_fp[: js.n_rows])
    answers_match(js, ts_, qs + [70], [(55, 70), (20, 70)])


def test_to_state_round_trip(rng):
    tw = Twin()
    keys = [f"K{i}" for i in range(20)]
    for v in (1, 2, 3):
        tw.t.update(v, keys[v:], mk_table(rng, len(keys) - v))
    state = tw.t.to_state()
    again = tstore.VersionedStore.from_state(state, device="cpu")
    back = again.to_state()
    assert back["version_digests"] == state["version_digests"]
    for name, log in state["logs"].items():
        for k, arr in log.items():
            assert np.array_equal(back["logs"][name][k], arr), (name, k)
    for a, b in zip(tw.t.get_versions([1, 2, 3]), again.get_versions([1, 2, 3])):
        same_view(a, b)


def test_from_state_rejects_inconsistent_logs(rng):
    js, _ = jax_history(rng, compact=False)
    state = jax_state(js)
    bad = dict(state, logs={k: v for k, v in state["logs"].items()
                            if k != "a"})
    with pytest.raises(ValueError, match="logs"):
        tstore.VersionedStore.from_state(bad, device="cpu")
    logs = dict(state["logs"])
    logs["a"] = dict(logs["a"], ptr=logs["a"]["ptr"][:-1])
    with pytest.raises(ValueError, match="pointers"):
        tstore.VersionedStore.from_state(dict(state, logs=logs), device="cpu")
