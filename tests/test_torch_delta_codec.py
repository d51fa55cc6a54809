"""The port's delta codec against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.delta_codec`` (the Pallas
bodies under ``interpret=True``, and its CPU default path) and
``repro_torch.kernels.delta_codec`` (whose wrappers take their plain torch
versions for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against
those on the card). Every comparison is exact: delta bits, per-tile stats,
round trips, and the chain codec's packed bytes and metadata.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import delta_codec as jdc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _compat  # noqa: E402
from repro_torch.kernels import delta_codec as tdc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.obs import kerneltel  # noqa: E402

TILE = 512
DTYPES = ["int8", "int16", "uint16", "int32", "uint32", "float16", "float32",
          "int64", "float64"]
SHAPES = [(5, 3), (700, 8), (513, 1)]


def extreme_pair(rng, dtype, shape):
    """(new, old) of ``dtype`` with the type's extremes (ints) or NaN and
    +-inf (floats) among random values, and some equal lanes."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        new = rng.integers(info.min, info.max, shape, endpoint=True,
                           dtype=dt)
        old = rng.integers(info.min, info.max, shape, endpoint=True,
                           dtype=dt)
        new.flat[0], old.flat[0] = info.min, info.max
        new.flat[-1], old.flat[-1] = info.max, info.min
        if dt.kind == "i":  # |INT_MIN| delta: min - 0
            new.flat[len(new.flat) // 2], old.flat[len(new.flat) // 2] = \
                info.min, 0
    else:
        new = rng.normal(scale=100, size=shape).astype(dt)
        old = rng.normal(scale=100, size=shape).astype(dt)
        new.flat[0], old.flat[-1] = np.nan, np.inf
        new.flat[-1] = -np.inf
    old[::3] = new[::3]  # unchanged lanes delta to zero
    return new, old


def lanes(a: np.ndarray) -> torch.Tensor:
    """The tensor the store would hand the wrapper: floats as floats,
    ints as the signed int of their width."""
    return torch.as_tensor(a if a.dtype.kind == "f" else _compat.bits_view(a))


def bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_codec_matches_jax(dtype, shape, rng):
    new, old = extreme_pair(rng, dtype, shape)
    tn, to = lanes(new), lanes(old)
    if new.dtype.itemsize == 8:
        want = jref.ref_delta_pack64(new, old)
        got = tdc.delta_pack_wide(tn, to)
        assert bits(got.numpy()) == bits(want)
        assert bits(got.numpy()) == bits(
            jdc.delta_pack_wide(new, old, interpret=True, tile=TILE))
        assert bits(tref.ref_delta_pack64(tn, to).numpy()) == bits(want)
        back = tdc.delta_unpack_wide(got, to)
        assert bits(back.numpy()) == bits(new)
        assert bits(back.numpy()) == bits(jref.ref_delta_unpack64(want, old))
        assert bits(back.numpy()) == bits(jdc.delta_unpack_wide(
            want, old, interpret=True, tile=TILE))
        return
    unsigned = new.dtype.kind == "u"
    got, stat = tdc.delta_pack(tn, to, unsigned=unsigned)
    jd, jstat = jdc.delta_pack(jnp.asarray(new), jnp.asarray(old),
                               interpret=True, tile=TILE)
    assert bits(got.numpy()) == bits(np.asarray(jd))
    assert bits(tref.ref_delta_pack(tn, to).numpy()) == bits(
        np.asarray(jref.ref_delta_pack(jnp.asarray(new), jnp.asarray(old))))
    # one stat per real 512-row tile, equal to the Pallas kernel's; its
    # padding tiles (none at these shapes) would be zero
    n_tiles = -(-shape[0] // TILE)
    assert stat.dtype == torch.int32 and stat.shape == (n_tiles,)
    assert np.array_equal(stat.numpy(), np.asarray(jstat)[:n_tiles])
    # the CPU default path folds the stat into one value
    _, jglobal = jdc.delta_pack(jnp.asarray(new), jnp.asarray(old))
    fold = stat.sum() if new.dtype.kind == "f" else stat.max()
    assert int(fold) == int(np.asarray(jglobal)[0])
    back = tdc.delta_unpack(got, to)
    assert bits(back.numpy()) == bits(new)
    assert bits(back.numpy()) == bits(np.asarray(jdc.delta_unpack(
        jd, jnp.asarray(old), interpret=True, tile=TILE)))
    assert bits(tref.ref_delta_unpack(got, to).numpy()) == bits(new)


def test_maxabs_stat_wraps_int32_min_like_jax():
    """A full tile whose every delta is INT32_MIN has the stat INT32_MIN
    (jnp.abs wraps); a ragged tile counts its zero padding, as the TPU
    launch pads it."""
    i32 = np.iinfo(np.int32)
    new = np.full((TILE + 3, 2), i32.min, np.int32)
    old = np.zeros_like(new)
    _, stat = tdc.delta_pack(torch.as_tensor(new), torch.as_tensor(old))
    _, jstat = jdc.delta_pack(jnp.asarray(new), jnp.asarray(old),
                              interpret=True, tile=TILE)
    assert stat.tolist() == [i32.min, 0] == np.asarray(jstat).tolist()


def test_uint16_stat_zero_extends(rng):
    """uint16 arrives as its int16 bit view; without ``unsigned`` its stat
    would sign-extend and come out small."""
    new = np.array([[65535], [0]], np.uint16)
    old = np.array([[0], [1]], np.uint16)
    tn, to = lanes(new), lanes(old)
    _, stat = tdc.delta_pack(tn, to, unsigned=True)
    _, jstat = jdc.delta_pack(jnp.asarray(new), jnp.asarray(old),
                              interpret=True, tile=TILE)
    assert stat.tolist() == [65535] == np.asarray(jstat).tolist()
    assert tdc.delta_pack(tn, to)[1].tolist() == [1]  # the signed reading


# ---------------------------------------------------------------------------
# the chain codec: the on-disk segment cell format
# ---------------------------------------------------------------------------

def sorted_rows(rng, c, n_rows):
    return np.sort(rng.integers(0, n_rows, c)).astype(np.int32)


def chain_cases(rng):
    rows = sorted_rows(rng, 300, 40)
    yield "int32 narrows to int8", rows, rng.integers(
        -60, 60, (300, 4)).astype(np.int32)
    yield "int32 narrows to int16", rows, (
        rng.integers(0, 20000, (300, 2))).astype(np.int32)
    yield "int32 stays int32", rows, rng.integers(
        -2**31, 2**31 - 1, (300, 3), endpoint=True).astype(np.int32)
    yield "uint32 deltas at and above 2**31", rows, rng.integers(
        0, 2**32, (300, 2)).astype(np.uint32)
    yield "uint32 small", rows, (4_000_000_000 + rng.integers(
        0, 50, (300, 2))).astype(np.uint32)
    yield "uint16", rows, (65500 + rng.integers(0, 36, (300, 3))).astype(
        np.uint16)
    yield "int16", rows, rng.integers(-300, 300, (300, 3)).astype(np.int16)
    yield "int8 EXISTS log", rows, rng.integers(0, 2, (300, 1)).astype(
        np.int8)
    yield "float32", rows, rng.normal(size=(300, 2)).astype(np.float32)
    yield "float16", rows, rng.normal(size=(300, 2)).astype(np.float16)
    yield "int64 min among small deltas", np.zeros(2, np.int32), np.array(
        [[5], [-2**63 + 5]], np.int64)
    yield "int64 narrows", rows, rng.integers(-200, 200, (300, 2))
    yield "int64 wide", np.array([0, 0, 1, 2], np.int32), np.array(
        [[2**40], [2**40 + 5], [7], [-2**45]], np.int64)
    yield "float64", rows, rng.normal(scale=1e300, size=(300, 3))
    yield "empty", np.zeros(0, np.int32), np.zeros((0, 2), np.int32)


def test_chain_pack_bytes_and_meta_match_jax(rng):
    seen = set()
    for what, rows, vals in chain_cases(rng):
        packed, meta = tops.chain_pack(vals, rows, device="cpu")
        jpacked, jmeta = jdc.chain_pack(vals, rows)
        assert meta == jmeta, what
        assert packed.dtype == jpacked.dtype, what
        assert packed.shape == jpacked.shape, what
        assert bits(packed) == bits(jpacked), what
        seen.add(meta.get("narrow"))
        back = tops.chain_unpack(packed, rows, meta, vals.dtype)
        assert back.dtype == vals.dtype and bits(back) == bits(vals), what
        jback = jdc.chain_unpack(jpacked, rows, jmeta, vals.dtype)
        assert bits(back) == bits(jback), what
    assert {"int8", "int16", "int32", None} <= seen


def test_chain_pack_counts_in_kernel_telemetry(rng):
    kerneltel.KERNELS.clear()
    rows = sorted_rows(rng, 50, 10)
    vals = rng.integers(0, 9, (50, 2)).astype(np.int32)
    packed, meta = tops.chain_pack(vals, rows, device="cpu")
    tops.chain_unpack(packed, rows, meta, vals.dtype)
    snap = kerneltel.KERNELS.snapshot()["delta_codec"]
    assert snap["calls"] == 2
    assert snap["bytes"] == 3 * vals.nbytes + 3 * packed.nbytes
    assert snap["padded_bytes"] == snap["bytes"]  # the port pads nothing


def test_chain_pack_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tops.chain_pack(np.ones((2, 1), np.int32), np.zeros(2, np.int32))


def test_codec_wrappers_reject_bad_inputs():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tdc.delta_pack(a, a.to(torch.int16))  # dtypes differ
    with pytest.raises(ValueError):
        tdc.delta_pack(a, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        tdc.delta_pack(a.t(), a.t())  # not contiguous
    with pytest.raises(ValueError):
        tdc.delta_pack(a.to(torch.int64), a.to(torch.int64))  # use _wide
    with pytest.raises(ValueError):
        tdc.delta_pack_wide(a, a)
    with pytest.raises(ValueError):
        tdc.delta_unpack(a.reshape(-1), a.reshape(-1))  # 1-D
    with pytest.raises(TypeError):
        tdc.delta_unpack(np.zeros((4, 2), np.int32), a)


def test_codec_cpu_tensors_count_no_launches(rng):
    names = ("delta_pack", "delta_unpack", "delta_pack_wide",
             "delta_unpack_wide")
    assert all(n in tops.KERNELS for n in names)
    before = {n: tops.KERNELS[n].launches for n in names}
    a = torch.as_tensor(rng.integers(0, 9, (7, 2)).astype(np.int32))
    w = a.to(torch.int64)
    tdc.delta_unpack(tdc.delta_pack(a, a)[0], a)
    tdc.delta_unpack_wide(tdc.delta_pack_wide(w, w), w)
    assert {n: tops.KERNELS[n].launches for n in names} == before


# -- the kernel's launch geometry (kernels/delta_codec.py: codec_plan) --------

I32_MIN = int(np.iinfo(np.int32).min)


def kernel_stats(delta: np.ndarray, itemsize: int, stat: str,
                 plan) -> list[int]:
    """The stat words the codec kernel leaves under ``plan``: each word
    starts at the plan's identity, and each of the tile's blocks folds in
    the stat of its chunk of the tile's flat lanes (the ragged tile's zero
    padding counted by each of its blocks) with an atomic max, or add for
    the count; folded in several block orders, which must not matter."""
    n, w = delta.shape
    v = delta.astype(np.int64)
    if stat == "maxabs_unsigned":
        v &= (1 << (8 * itemsize)) - 1
    mag = np.abs(v)
    mag = np.where(mag >= 2**31, mag - 2**32, mag)   # |INT32_MIN| wraps
    words = []
    for t in range(plan.n_tiles):
        rows = min(TILE, n - t * TILE)
        flat_nz = (delta[t * TILE:t * TILE + rows] != 0).reshape(-1)
        flat_mag = mag[t * TILE:t * TILE + rows].reshape(-1)
        parts = []
        for p in range(plan.blocks_per_tile):
            lo, hi = p * plan.chunk, (p + 1) * plan.chunk
            if stat == "nonzero":
                parts.append(int(flat_nz[lo:hi].sum()))
            elif stat != "none":
                m = int(flat_mag[lo:hi].max()) if flat_mag[lo:hi].size \
                    else I32_MIN
                parts.append(max(m, 0) if rows < TILE else m)
        outcomes = set()
        for order in (parts, parts[::-1], parts[1::2] + parts[::2]):
            word = plan.identity
            for x in order:
                word = word + x if stat == "nonzero" else max(word, x)
            outcomes.add(word)
        assert len(outcomes) == 1
        words.append(outcomes.pop())
    return words


@pytest.mark.parametrize("w", [1, 3, 9, 64])
@pytest.mark.parametrize("n", [1, 511, 512, 513])
def test_codec_plan_folds_to_the_tile_stats(n, w, rng):
    """The launch geometry against ``ref_tile_stat``'s stat layout: chunks
    of whole 16-byte vectors that cover each tile's lanes with no block
    empty in a full tile, whole warps, a tile with a stat over several
    blocks a cluster of at most 8, the identity the word starts at, and the stats the blocks' atomic
    folds leave equal to the plain version's, for every lane width and
    stat kind, with INT_MIN lanes, and at int32 a tile's first 256 rows
    INT32_MIN (whole chunks of it beside others)."""
    for dtype in ("int8", "int16", "uint16", "int32"):
        new, old = extreme_pair(rng, dtype, (n, w))
        tn, to = lanes(new), lanes(old)
        d = tref.ref_codec(tn, to, "sub")
        if dtype == "int32":  # whole chunks of |INT32_MIN| beside others
            d[:256] = I32_MIN
        s = d.element_size()
        for stat in ("maxabs", "maxabs_unsigned", "nonzero", "none"):
            if stat == "maxabs_unsigned" and s == 4:
                continue
            plan = tdc.codec_plan(n, w, s, stat)
            lanes_per_tile = TILE * w
            assert plan.n_tiles == -(-n // TILE)
            assert plan.blocks == plan.n_tiles * plan.blocks_per_tile
            assert plan.chunk % (16 // s) == 0
            assert (plan.blocks_per_tile - 1) * plan.chunk < lanes_per_tile
            assert plan.blocks_per_tile * plan.chunk >= lanes_per_tile
            assert plan.cluster == (stat != "none"
                                    and plan.blocks_per_tile > 1)
            if plan.cluster:
                assert plan.blocks_per_tile <= tdc.MAX_BLOCKS_PER_TILE
                assert plan.threads == tdc.CLUSTER_THREADS
            else:
                assert plan.chunk * s <= tdc.CHUNK_BYTES + 16
                assert plan.threads <= tdc.BLOCK_THREADS
            assert plan.threads % 32 == 0
            assert plan.identity == (I32_MIN if stat.startswith("maxabs")
                                     else 0)
            kind = "maxabs" if stat.startswith("maxabs") else stat
            want = tref.ref_tile_stat(d, TILE, kind,
                                      unsigned=stat == "maxabs_unsigned")
            assert kernel_stats(d.numpy(), s, stat, plan) == want.tolist()


def test_codec_plan_cuts_wide_tiles_into_a_cluster_of_blocks():
    """At the sequence log's W = 64 int32 a tile is 128 KB of each operand:
    a cluster of 8 blocks of 16 KB and 256 threads, so the grid is many
    waves of small blocks; at W = 8 one block of 1,024 threads, a vector
    of each operand per thread; a W = 1 int8 tile is one warp's block of
    512 bytes; with no stat, a tile is cut into 16 KB blocks and no
    cluster."""
    p = tdc.codec_plan(733_845, 64, 4, "maxabs")
    assert (p.n_tiles, p.blocks_per_tile, p.chunk, p.threads, p.cluster,
            p.identity) == (1434, 8, 4096, 256, True, I32_MIN)
    assert p.blocks == 11_472
    p = tdc.codec_plan(4_706_255, 8, 4, "maxabs")
    assert (p.blocks_per_tile, p.chunk, p.threads, p.cluster) == (
        1, 4096, 1024, False)
    p = tdc.codec_plan(1000, 1, 1, "maxabs")
    assert (p.blocks_per_tile, p.chunk, p.threads) == (1, 512, 32)
    assert tdc.codec_plan(733_845, 64, 4, "nonzero").identity == 0
    p = tdc.codec_plan(733_845, 64, 8, "none")
    assert (p.blocks_per_tile, p.chunk, p.threads, p.cluster) == (
        16, 2048, 1024, False)


def test_codec_output_shares_the_inputs_alignment():
    """The wrapper's output starts at the input's address mod 16, so a,
    b and out line up for the kernel's 16-byte vectors, with the same
    shape and dtype and contiguous."""
    for dtype, shift in ((torch.int32, 1), (torch.int32, 2),
                         (torch.int8, 5), (torch.int16, 0)):
        buf = torch.zeros(4096, dtype=dtype)
        a = buf[shift:shift + 600].view(100, 6)
        out = tdc._aligned_like(a)
        assert out.shape == a.shape and out.dtype == a.dtype
        assert out.is_contiguous()
        assert out.data_ptr() % 16 == a.data_ptr() % 16


def test_codec_plan_keeps_a_tile_of_int32_min_int32_min():
    """A full tile whose every delta is INT32_MIN: each of its 8 blocks
    has the partial INT32_MIN, and the word stays at the identity,
    INT32_MIN (ref_tile_stat and jnp.abs agree); a ragged one counts its
    padding."""
    d = np.full((TILE + 7, 64), I32_MIN, np.int32)
    plan = tdc.codec_plan(len(d), 64, 4, "maxabs")
    assert plan.blocks_per_tile == 8
    want = tref.ref_tile_stat(torch.as_tensor(d), TILE, "maxabs").tolist()
    assert kernel_stats(d, 4, "maxabs", plan) == want == [I32_MIN, 0]
