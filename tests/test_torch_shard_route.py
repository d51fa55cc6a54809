"""The sharding slice's kernel modules against the JAX package's, on the
CPU: the key -> shard route and the stacked (cross-shard) masked cumsum.

The same numpy inputs go through ``repro.kernels`` (its default dispatch,
and ``interpret=True`` so the Pallas bodies themselves run) and
``repro_torch.kernels`` (whose wrappers take their plain torch versions
for CPU tensors; the CUDA kernels are held against those on the card by
``chip_smoke.py``). Every result must be equal, with no tolerance: the
route decides which shard directory a key's cells are saved in.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import batched_select as jbs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import shard_route as jroute  # noqa: E402
from repro_torch.kernels import _compat  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import shard_route as troute  # noqa: E402

TS_MAX = 2**31 - 2
I32 = np.iinfo(np.int32)
SHARD_NS = (1, 2, 5, 7)


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def route_keys_set():
    """The key set of the JAX package's own route test, plus the empty
    key, keys whose real bytes end in zeros, and keys wider than 31 lanes
    (124 bytes), so the rotation amount wraps."""
    rng = np.random.default_rng(3)
    keys = [f"K{i:06d}".encode() for i in range(1500)] + [b"", b"\x00\x00"]
    keys += [b"", b"\x00", b"a", b"a\x00", b"a\x00\x00\x00\x00",
             b"P12345\x00", b"\x00" * 9]
    keys += [b"x" * 125, b"y" * 200 + b"\x00",
             bytes(rng.integers(0, 256, 131, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 257, dtype=np.uint8))]
    return keys


# ---------------------------------------------------------------------------
# shard_route
# ---------------------------------------------------------------------------

def test_route_constants_and_version_match_jax():
    for name in ("RT_MUL1", "RT_MUL2", "RT_MUL3", "RT_MUL4"):
        assert getattr(tref, name) == getattr(jref, name)
    assert troute.ROUTING_VERSION == jroute.ROUTING_VERSION


def test_key_lanes_match_jax():
    keys = route_keys_set()
    lanes, lens = troute.key_lanes(keys)
    jl, jn = jroute.key_lanes(keys)
    assert lanes.dtype == np.int32 and lens.dtype == np.int32
    assert np.array_equal(lanes, jl) and np.array_equal(lens, jn)
    assert lanes.shape[1] > 31  # the rotation amount wraps


@pytest.mark.parametrize("n_shards", SHARD_NS)
def test_shard_route_matches_jax_ref_and_pallas_body(n_shards):
    lanes, lens = jroute.key_lanes(route_keys_set())
    got = tops.shard_route(t(lanes), t(lens), n_shards).numpy()
    assert got.dtype == np.int32
    want = np.asarray(jref.ref_shard_route(jnp.asarray(lanes),
                                           jnp.asarray(lens), n_shards))
    assert np.array_equal(got, want)
    body = np.asarray(jroute.shard_route(jnp.asarray(lanes),
                                         jnp.asarray(lens), n_shards,
                                         interpret=True))
    assert np.array_equal(got, body)
    assert got.min() >= 0 and got.max() < n_shards
    assert np.array_equal(tref.ref_shard_route(t(lanes), t(lens),
                                               n_shards).numpy(), got)


@pytest.mark.parametrize("n_shards", SHARD_NS)
def test_route_keys_match_jax_and_are_width_stable(n_shards):
    keys = route_keys_set()
    got = troute.route_keys(keys, n_shards, "cpu")
    assert np.array_equal(got, jroute.route_keys(keys, n_shards))
    # the same key routes alike however wide its batch was padded
    solo = np.array([troute.route_keys([k], n_shards, "cpu")[0]
                     for k in keys[-12:]])
    assert np.array_equal(got[-12:], solo)
    # keys that differ only in trailing zero bytes are told apart by length
    lanes, lens = troute.key_lanes([b"a", b"a\x00", b"a\x00\x00\x00\x00"])
    assert len(set(map(tuple, lanes))) == 1 and len(set(lens)) == 3


def test_route_keys_balance_and_guards():
    r = troute.route_keys([f"P{i:08d}".encode() for i in range(5000)], 4,
                          "cpu")
    assert np.bincount(r, minlength=4).min() > 5000 / 4 * 0.7
    for bad in (0, -1):
        with pytest.raises(ValueError):
            troute.route_keys([b"k"], bad, "cpu")
        with pytest.raises(ValueError):
            tops.shard_route(t(np.zeros((1, 1), np.int32)),
                             t(np.zeros(1, np.int32)), bad)
    assert troute.route_keys([], 3, "cpu").shape == (0,)
    assert not troute.route_keys([b"a", b"b"], 1, "cpu").any()
    with pytest.raises(ValueError):  # lengths do not match the lanes
        tops.shard_route(t(np.zeros((2, 1), np.int32)),
                         t(np.zeros(3, np.int32)), 2)
    with pytest.raises(ValueError):
        tops.shard_route(t(np.zeros((2, 1), np.int64)),
                         t(np.zeros(2, np.int32)), 2)


@pytest.mark.parametrize("parts", [
    [np.array([0, 3, 9]), np.array([], np.int64), np.array([1, 4])],
    [],
    [np.array([5]), np.array([0, 1, 2, 7]), np.array([3, 4, 6, 8])],
])
def test_merge_shard_rows_matches_jax(parts):
    rows, order = troute.merge_shard_rows(parts)
    jrows, jorder = jroute.merge_shard_rows(parts)
    assert np.array_equal(rows, jrows) and np.array_equal(order, jorder)
    assert rows.dtype == jrows.dtype and order.dtype == jorder.dtype
    cat = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    assert np.array_equal(cat[order], rows)
    assert np.all(np.diff(rows) > 0)


# ---------------------------------------------------------------------------
# the ragged-key route: flat key bytes + offsets (the store's route)
# ---------------------------------------------------------------------------

def ragged_keys_set():
    """The edge keys (empty, one zero byte, real trailing zero bytes, 125,
    201 and 257 bytes, random non-ASCII) and ordinary accessions."""
    rng = np.random.default_rng(11)
    keys = [b"", b"\x00", b"a\x00", b"a\x00\x00\x00\x00", b"P12345\x00",
            b"x" * 125, b"y" * 200 + b"\x00",
            bytes(rng.integers(0, 256, 257, dtype=np.uint8)),
            bytes(rng.integers(128, 256, 13, dtype=np.uint8)), b""]
    return keys + [b"P%08d" % i for i in range(700)]


@pytest.mark.parametrize("n_shards", SHARD_NS)
def test_route_bytes_matches_jax_route_keys(n_shards):
    keys = ragged_keys_set()
    want = jroute.route_keys(keys, n_shards)
    flat, offsets = troute.key_bytes(keys)
    got = tref.ref_shard_route_bytes(t(flat), t(offsets), n_shards).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(tops.shard_route_bytes(t(flat), t(offsets),
                                                 n_shards).numpy(), want)
    assert np.array_equal(troute.route_keys(keys, n_shards, "cpu"), want)
    # the lanes entry point on the same keys
    lanes, lens = troute.key_lanes(keys)
    assert np.array_equal(
        tops.shard_route(t(lanes), t(lens), n_shards).numpy(), got)


def test_key_bytes_lay_keys_end_to_end():
    keys = ragged_keys_set()
    flat, offsets = troute.key_bytes(keys)
    assert flat.dtype == np.uint8 and offsets.dtype == np.int64
    assert flat.flags.writeable  # torch takes it without a copy or warning
    assert offsets.shape == (len(keys) + 1,) and offsets[0] == 0
    assert offsets[-1] == flat.size == sum(map(len, keys))
    assert np.array_equal(np.diff(offsets), [len(k) for k in keys])
    assert all(flat[offsets[i]:offsets[i + 1]].tobytes() == k
               for i, k in enumerate(keys))
    flat, offsets = troute.key_bytes([])
    assert flat.shape == (0,) and offsets.tolist() == [0]
    flat, offsets = troute.key_bytes([b"", b""])
    assert flat.shape == (0,) and offsets.tolist() == [0, 0, 0]


@pytest.mark.parametrize("pre", [1, 2, 3, 5])
def test_route_bytes_on_a_view_with_storage_offset(pre):
    """Keys in a slice of a larger buffer, offsets that do not start at
    0: the kernel builds lanes from words at any byte alignment, and the
    plain version indexes the same bytes."""
    keys = ragged_keys_set()[:40]
    flat, offsets = troute.key_bytes(keys)
    big = torch.full((flat.size + pre + 7,), 0xAB, dtype=torch.uint8)
    big[pre:pre + flat.size] = t(flat)
    view = big[1:]  # a storage offset; keys at pre - 1 bytes into it
    got = tops.shard_route_bytes(view, t(offsets + (pre - 1)), 5).numpy()
    assert np.array_equal(got, jroute.route_keys(keys, 5))


def test_route_keys_builds_no_padded_lanes(monkeypatch):
    """route_keys hands the kernel flat key bytes: key_lanes (the per-key
    packing loop) is not on its path."""
    def refuse(keys):
        raise AssertionError("route_keys packed padded lanes")
    seen = []
    real = troute.shard_route_bytes

    def spy(flat, offsets, n_shards):
        seen.append((flat.shape[0], offsets.shape[0], n_shards))
        return real(flat, offsets, n_shards)
    monkeypatch.setattr(troute, "key_lanes", refuse)
    monkeypatch.setattr(troute, "shard_route_bytes", spy)
    keys = ragged_keys_set()
    got = troute.route_keys(keys, 7, "cpu")
    assert np.array_equal(got, jroute.route_keys(keys, 7))
    assert seen == [(sum(map(len, keys)), len(keys) + 1, 7)]


def test_route_bytes_guards_and_counts_no_cpu_launches():
    flat = t(np.frombuffer(b"abcdef", np.uint8).copy())
    off = t(np.array([0, 2, 6], np.int64))
    before = tops.shard_route_bytes.launches
    assert tops.shard_route_bytes(flat, off, 3).shape == (2,)
    assert tops.shard_route_bytes.launches == before
    assert tops.KERNELS["shard_route_bytes"] is tops.shard_route_bytes
    with pytest.raises(ValueError):  # offsets must be int64
        tops.shard_route_bytes(flat, off.to(torch.int32), 3)
    with pytest.raises(ValueError):  # the keys' bytes must be uint8
        tops.shard_route_bytes(flat.to(torch.int32), off, 3)
    with pytest.raises(ValueError):  # N + 1 offsets, at least one
        tops.shard_route_bytes(flat, off[:0], 3)
    for bad in (0, 2**31):
        with pytest.raises(ValueError):
            tops.shard_route_bytes(flat, off, bad)
    with pytest.raises(TypeError):
        tops.shard_route_bytes(b"abcdef", off, 3)
    assert tops.shard_route_bytes(flat[:0], off[:1], 3).shape == (0,)


# ---------------------------------------------------------------------------
# stacked masked cumsum and boundary select
# ---------------------------------------------------------------------------

def stack(rng, s, c, n_real):
    """(S, C) fused ts rows, each ascending over its first n_real[i] cells
    and padded with int32 max after them (the placement's stacking)."""
    ts = np.full((s, c), I32.max, np.int32)
    for i, n in enumerate(n_real):
        ts[i, :n] = np.sort(rng.integers(-5, 97, n))
    return ts


def queries(rng, q):
    tq = rng.integers(-10, 110, q).astype(np.int32)
    tq[0] = TS_MAX
    if q > 1:
        tq[-1] = -(2**31) + 1
    return tq


def boundaries(rng, s, c, b):
    bnd = np.sort(rng.integers(0, c + 1, (s, b)), axis=1).astype(np.int32)
    bnd[:, 0] = 0  # boundary 0 reads count 0
    bnd[:, -1] = c
    bnd[-1, b // 2:] = 0  # zero-padded rows, as the placement pads them
    return bnd


@pytest.mark.parametrize("s", [1, 3, 4])
@pytest.mark.parametrize("c", [1, 37, 300])
def test_stacked_masked_cumsum_matches_pallas_body(s, c, rng):
    """The Pallas body (interpret mode, a 128-cell tile so the ragged
    tile and several tiles occur at small C) against the port."""
    ts = stack(rng, s, c, [c, max(c - 7, 0), c // 2, 0][:s])
    tq = queries(rng, 3)
    got = tops.stacked_masked_cumsum(t(ts), t(tq)).numpy()
    assert got.dtype == np.int32 and got.shape == (s, 3, c)
    body = np.asarray(jbs.stacked_masked_cumsum(
        jnp.asarray(ts), jnp.asarray(tq), interpret=True, tile=128))
    assert np.array_equal(got, body)


@pytest.mark.parametrize("s", [1, 3, 4])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_stacked_scan_and_boundary_select_match_jax(s, q, rng):
    c = 2049  # ragged against the port's 2048-cell tile
    ts = stack(rng, s, c, [c, 1500, 2047, 0][:s])
    tq = queries(rng, q)
    bnd = boundaries(rng, s, c, 11)
    got = tops.stacked_masked_cumsum(t(ts), t(tq)).numpy()
    assert np.array_equal(got, np.asarray(jref.ref_stacked_masked_cumsum(
        jnp.asarray(ts), jnp.asarray(tq))))
    sel = tops.stacked_boundary_select(t(ts), t(tq), t(bnd)).numpy()
    assert sel.dtype == np.int32 and sel.shape == (s, q, 11)
    want = np.asarray(jbs.stacked_boundary_select(
        jnp.asarray(ts), jnp.asarray(tq), jnp.asarray(bnd)))
    assert np.array_equal(sel, want)
    assert np.array_equal(tref.ref_stacked_boundary_select(
        t(ts), t(tq), t(bnd)).numpy(), want)
    # padding never counts: a shard's last boundary reads its real cells
    for i in range(s):
        real = int((ts[i] < I32.max).sum())
        assert (got[i, :, -1] <= real).all()


def test_stacked_boundary_select_edges(rng):
    # C = 0: every boundary is 0 and reads 0
    empty = tops.stacked_boundary_select(
        torch.zeros((2, 0), dtype=torch.int32), t(queries(rng, 3)),
        torch.zeros((2, 4), dtype=torch.int32))
    assert empty.shape == (2, 3, 4) and not empty.any()
    # Q = 0 and S = 0
    ts = stack(rng, 2, 9, [9, 4])
    assert tops.stacked_masked_cumsum(t(ts), t(np.zeros(0, np.int32))
                                      ).shape == (2, 0, 9)
    assert tops.stacked_masked_cumsum(torch.zeros((0, 9), dtype=torch.int32),
                                      t(queries(rng, 2))).shape == (0, 2, 9)
    with pytest.raises(ValueError):  # one boundary row per shard
        tops.stacked_boundary_select(t(ts), t(queries(rng, 2)),
                                     torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.stacked_masked_cumsum(t(ts[0]), t(queries(rng, 2)))


def test_stacked_and_route_count_no_cpu_launches(rng):
    before = {k: fn.launches for k, fn in tops.KERNELS.items()}
    assert {"shard_route", "stacked_masked_cumsum"} <= set(before)
    tops.stacked_masked_cumsum(t(stack(rng, 2, 5, [5, 3])),
                               t(queries(rng, 2)))
    tops.shard_route(t(np.ones((3, 2), np.int32)), t(np.ones(3, np.int32)),
                     3)
    assert {k: fn.launches for k, fn in tops.KERNELS.items()} == before


def test_launch_counts_lose_no_update_across_threads():
    """A sharded release session launches kernels from one worker thread
    per shard; the wrappers' counts must not lose an increment."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, per_thread = 16, 2000

    def work():
        for _ in range(per_thread):
            _compat.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread
