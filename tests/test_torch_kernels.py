"""The port's kernel modules against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels`` (its default dispatch,
and ``interpret=True`` at tiny shapes so the Pallas bodies themselves run)
and ``repro_torch.kernels`` (whose wrappers take their plain torch
versions for CPU tensors; the CUDA kernels are held against those plain
versions on the card by ``chip_smoke.py``). Integer results must be equal,
with no tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import compact_rewrite as jcompact  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, _compat  # noqa: E402
from repro_torch.kernels import fingerprint as tfp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TS_MAX = 2**31 - 2
I32 = np.iinfo(np.int32)


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def extreme_lanes(rng, n, w):
    lanes = rng.integers(I32.min, I32.max, (n, w), dtype=np.int32,
                         endpoint=True)
    lanes[0, 0], lanes[-1, -1] = I32.min, I32.max
    lanes[n // 2, :] = -1
    return lanes


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 7, 64])
def test_fingerprint_matches_jax(w, rng):
    lanes = extreme_lanes(rng, 300, w)
    got = tops.fingerprint(t(lanes)).numpy()
    assert got.dtype == np.int32 and got.shape == (300, 2)
    assert np.array_equal(got, np.asarray(jops.fingerprint(jnp.asarray(lanes))))
    small = lanes[:61]  # the Pallas body itself, through the interpreter
    assert np.array_equal(
        tops.fingerprint(t(small)).numpy(),
        np.asarray(jops.fingerprint(jnp.asarray(small), interpret=True)))


def test_fingerprint_empty_and_constants():
    assert tops.fingerprint(torch.zeros((0, 3), dtype=torch.int32)).shape == (0, 2)
    for name in ("FNV1_INIT", "FNV1_MUL", "FNV2_INIT", "FNV2_MUL"):
        assert getattr(tref, name) == getattr(jref, name)


@pytest.mark.parametrize("w", [3, 4, 5, 8, 9, 12, 16, 17, 63, 65, 128, 300])
def test_fingerprint_matches_jax_at_edge_widths(w, rng):
    """The widths around the kernel's paths: rows (W <= 8), 16-byte tiles
    (W % 4 == 0), 4-byte tiles, and rows staged in chunks (W > 128)."""
    lanes = extreme_lanes(rng, 257, w)
    got = tops.fingerprint(t(lanes)).numpy()
    assert np.array_equal(got, np.asarray(jops.fingerprint(jnp.asarray(lanes))))


@pytest.mark.parametrize("w", [1, 8, 12, 64, 65])
def test_fingerprint_on_a_view_with_storage_offset(w, rng):
    """A contiguous row slice of a larger buffer: its base lies 4 bytes
    past a 16-byte boundary whenever the buffer's does not, and the plan
    then takes the 4-byte tile copy (or the rows path)."""
    lanes = extreme_lanes(rng, 130, w)
    buf = torch.zeros(lanes.size + 8, dtype=torch.int32)
    view = buf[1:1 + lanes.size].view(130, w)
    view.copy_(t(lanes))
    assert view.storage_offset() == 1 and view.is_contiguous()
    got = tops.fingerprint(view).numpy()
    assert np.array_equal(got, np.asarray(jops.fingerprint(jnp.asarray(lanes))))
    plan = tfp.fingerprint_plan(w, view.data_ptr() % 16)
    assert plan.path == ("rows" if w <= 8 else "tile4"
                         if view.data_ptr() % 16 else "tile16" if w % 4 == 0
                         else "tile4")


@pytest.mark.parametrize("align", [0, 4, 8, 12])
def test_fingerprint_plan(align):
    for w in list(range(0, 70)) + [127, 128, 129, 255, 256, 300, 1000, 4097]:
        p = tfp.fingerprint_plan(w, align)
        if w <= 8:
            assert p.path == "rows" and p.threads == tfp.ROWS_THREADS
            assert p.rows_per_tile == 4 * p.threads and p.smem_bytes == 0
            continue
        vec16 = w % 4 == 0 and align == 0
        assert p.path == ("tile16" if vec16 else "tile4")
        assert p.threads == p.rows_per_tile
        assert p.threads % 32 == 0 and 32 <= p.threads <= 256
        assert p.lanes_per_chunk == min(w, 128) and p.stages == 2
        assert p.smem_bytes == p.stages * p.rows_per_tile * p.row_stride * 4
        assert p.smem_bytes <= 227 * 1024
        r = np.arange(32)
        if vec16:
            assert p.lanes_per_chunk % 4 == 0 and p.row_stride % 4 == 0
            pieces = p.row_stride // 4
            assert pieces % 2 == 1 and pieces >= p.lanes_per_chunk // 4
            # a quarter-warp's 16-byte reads of one piece of eight rows
            # fall in eight distinct 16-byte bank groups
            for c in range(p.lanes_per_chunk // 4):
                for q0 in range(0, 32, 8):
                    groups = (r[q0:q0 + 8] * pieces + c) % 8
                    assert len(set(groups.tolist())) == 8
        else:
            assert p.row_stride % 2 == 1
            assert p.row_stride >= p.lanes_per_chunk
            # a warp's 4-byte reads of one word of 32 rows: 32 banks
            for c in range(p.lanes_per_chunk):
                assert len(set(((r * p.row_stride + c) % 32).tolist())) == 32
    # a tile of whole rows holds about TILE_BYTES
    assert tfp.fingerprint_plan(64, 0).rows_per_tile == 128
    assert tfp.fingerprint_plan(16, 0).rows_per_tile == 256


def emulate_fingerprint(lanes: np.ndarray, plan, grid: int) -> np.ndarray:
    """The kernel's schedule and addressing in numpy, at a grid of
    ``grid`` blocks. Rows path: warp v folds rows r0 + lane + 32 k for
    r0 = 128 v, 128 (v + warps), ... Tile paths: block b walks items i =
    0, 1, ... (tile b + (i // chunks) * grid, chunk i % chunks), copies
    the item's lanes into stage i % 2 (unit by unit as the threads do, row
    r at r * row_stride words; the rest of the stage holds garbage), then
    each row folds its lanes from the stage, keeping its hash across
    chunks. Returns the (N, 2) int32 fingerprints; raises if a row is
    folded twice or never."""
    n, w = lanes.shape
    m32 = np.uint64(0xFFFFFFFF)
    x = lanes.reshape(-1).view(np.uint32).astype(np.uint64)
    init = (int(tref.FNV1_INIT) & 0xFFFFFFFF, int(tref.FNV2_INIT) & 0xFFFFFFFF)
    mul1, mul2 = np.uint64(int(tref.FNV1_MUL)), np.uint64(int(tref.FNV2_MUL))
    out = np.zeros((n, 2), np.int64)
    folded = np.zeros(n, np.int64)

    def fold(h1, h2, xs, j1):
        return ((h1 ^ xs) * mul1) & m32, (((h2 * mul2) & m32)
                                          ^ ((xs + np.uint64(j1)) & m32))

    def finish(rows, h1, h2):
        a = h1 ^ ((h2 << np.uint64(13)) & m32)
        # >> 7 on the int32 value: an arithmetic shift
        a_signed = a.astype(np.uint32).view(np.int32).astype(np.int64)
        out[rows, 0] = a
        out[rows, 1] = h2 ^ ((a_signed >> 7).astype(np.uint64) & m32)
        folded[rows] += 1

    if plan.path == "rows":
        warps = grid * plan.threads // 32
        for v in range(warps):
            for r0 in range(128 * v, n, 128 * warps):
                rows = (r0 + np.arange(32)[None, :]
                        + 32 * np.arange(4)[:, None]).reshape(-1)
                rows = rows[rows < n]
                h1 = np.full(rows.size, init[0], np.uint64)
                h2 = np.full(rows.size, init[1], np.uint64)
                for j in range(w):
                    h1, h2 = fold(h1, h2, x[rows * w + j], j + 1)
                finish(rows, h1, h2)
    else:
        rows_t, k = plan.rows_per_tile, plan.lanes_per_chunk
        stride = plan.row_stride
        unit = 4 if plan.path == "tile16" else 1
        n_tiles, chunks = -(-n // rows_t), -(-w // k)
        for b in range(min(grid, n_tiles)):
            stages = np.zeros((2, rows_t * stride), np.uint64)
            items = -(-(n_tiles - b) // grid) * chunks
            for i in range(items):
                r0 = (b + i // chunks * grid) * rows_t
                k0, nr = i % chunks * k, min(rows_t, n - r0)
                kc = min(k, w - k0)
                stage = stages[i % 2]
                stage[:] = 0xDEADBEEF
                u = np.arange(nr * (kc // unit))
                r, q = u // (kc // unit), u % (kc // unit)
                for e in range(unit):
                    stage[r * stride + unit * q + e] = x[
                        (r0 + r) * w + k0 + unit * q + e]
                t_ = np.arange(nr)
                if k0 == 0:
                    h1 = np.full(rows_t, init[0], np.uint64)
                    h2 = np.full(rows_t, init[1], np.uint64)
                for j in range(kc):
                    h1[:nr], h2[:nr] = fold(h1[:nr], h2[:nr],
                                            stage[t_ * stride + j], k0 + j + 1)
                if k0 + kc == w:
                    finish(r0 + t_, h1[:nr], h2[:nr])
    if not (folded == 1).all():
        raise AssertionError(f"rows folded {np.unique(folded)} times")
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("w,align,n,grid", [
    (1, 0, 1000, 2), (3, 4, 517, 1), (8, 0, 1000, 3), (12, 0, 600, 2),
    (16, 4, 700, 2), (17, 0, 600, 2), (64, 0, 1000, 3), (65, 8, 300, 2),
    (300, 0, 130, 2), (257, 4, 70, 1)])
def test_fingerprint_kernel_schedule_emulated(w, align, n, grid, rng):
    """The kernel's persistent schedule, double-buffered stages and padded
    row addressing, emulated in numpy from its plan, give the JAX
    package's fingerprints, each row folded once (ragged last tiles,
    several tiles per block, rows staged in chunks)."""
    lanes = extreme_lanes(rng, n, w)
    got = emulate_fingerprint(lanes, tfp.fingerprint_plan(w, align), grid)
    assert np.array_equal(got, np.asarray(jops.fingerprint(jnp.asarray(lanes))))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "float16", "float32", "uint32", "int32"])
def test_to_int_lanes_and_fingerprint_rows_match_jax(dtype, rng):
    dt = np.dtype(dtype)
    raw = rng.integers(0, 256, (40, 3 * dt.itemsize), dtype=np.uint8)
    x = raw.view(dt)  # every bit pattern, NaNs and extremes included
    got = tops.to_int_lanes(x, "cpu").numpy()
    want = np.asarray(jops.to_int_lanes(x))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(tops.fingerprint_rows(x, "cpu"),
                          jops.fingerprint_rows(x))


def test_to_int_lanes_sign_extends_narrow_lanes():
    """Parity hazard: the JAX package SIGN-extends 1- and 2-byte lanes
    (its docstring says zero-extended); the port copies the code."""
    x = np.array([[65535, 1, 32768]], np.uint16)
    assert tops.to_int_lanes(x, "cpu").tolist() == [[-1, 1, -32768]]
    assert np.asarray(jops.to_int_lanes(x)).tolist() == [[-1, 1, -32768]]
    assert tops.to_int_lanes(np.array([255], np.uint8), "cpu").tolist() == [[-1]]


def test_to_int_lanes_refuses_wide_dtypes():
    with pytest.raises(TypeError):
        tops.to_int_lanes(np.zeros((2, 2), np.int64), "cpu")


# ---------------------------------------------------------------------------
# masked cumsum (single and batched) and version select
# ---------------------------------------------------------------------------

QUERIES = np.array([-(2**31) + 1, -3, 0, 13, 96, TS_MAX], np.int32)


@pytest.mark.parametrize("c", [1, 7, 2047, 2049, 4096])
def test_masked_cumsum_matches_jax(c, rng):
    ts = np.sort(rng.integers(-5, 97, c)).astype(np.int32)
    ts[-1] = TS_MAX
    for q in QUERIES:
        got = tops.masked_cumsum(t(ts), int(q))
        # parity hazard: torch.cumsum of int32 is int64 unless asked
        assert got.dtype == torch.int32
        want = np.asarray(jops.masked_cumsum(jnp.asarray(ts), int(q)))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), np.asarray(jops.masked_cumsum(
            jnp.asarray(ts), int(q), interpret=True)))


@pytest.mark.parametrize("c", [1, 2047, 2049, 4096])
def test_batched_masked_cumsum_matches_jax(c, rng):
    ts = rng.integers(-50, 150, c).astype(np.int32)  # unsorted is fine
    got = tops.batched_masked_cumsum(t(ts), t(QUERIES))
    assert got.dtype == torch.int32 and got.shape == (len(QUERIES), c)
    want = np.asarray(jops.batched_masked_cumsum(jnp.asarray(ts),
                                                 jnp.asarray(QUERIES)))
    assert np.array_equal(got.numpy(), want)
    q4 = QUERIES[[0, 2, 4, 5]]
    assert np.array_equal(
        tops.batched_masked_cumsum(t(ts), t(q4)).numpy(),
        np.asarray(jops.batched_masked_cumsum(jnp.asarray(ts), jnp.asarray(q4),
                                              interpret=True)))


def test_masked_cumsum_rejects_out_of_range_query():
    with pytest.raises(ValueError):
        tops.masked_cumsum(t(np.zeros(3, np.int32)), 2**31)


def mk_csr_log(rng, n_rows, n_cells, width=3):
    rows = rng.integers(0, n_rows, n_cells).astype(np.int32)
    tss = rng.integers(0, 100, n_cells).astype(np.int32)
    order = np.lexsort((tss, rows))
    rows, tss = rows[order], tss[order]
    vals = rng.integers(-50, 50, (n_cells, width)).astype(np.int32)
    ptr = np.zeros(n_rows + 1, np.int32)
    np.add.at(ptr, rows + 1, 1)
    return vals, tss, np.cumsum(ptr).astype(np.int32)


def test_version_select_matches_jax(rng):
    vals, tss, ptr = mk_csr_log(rng, 41, 300)
    tq = np.array([0, 5, 50, 99, 100, TS_MAX], np.int32)
    out, found = tops.batched_version_select(t(vals), t(tss), t(ptr), t(tq))
    jout, jfound = jops.batched_version_select(
        jnp.asarray(vals), jnp.asarray(tss), jnp.asarray(ptr), jnp.asarray(tq))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    for i, q in enumerate(tq):
        o1, f1 = tops.version_select(t(vals), t(tss), t(ptr), int(q))
        jo, jf = jops.version_select(jnp.asarray(vals), jnp.asarray(tss),
                                     jnp.asarray(ptr), int(q))
        assert np.array_equal(o1.numpy(), np.asarray(jo))
        assert np.array_equal(f1.numpy(), np.asarray(jf))
        assert np.array_equal(o1.numpy(), out.numpy()[i])


def test_version_select_empty_log():
    out, found = tops.batched_version_select(
        torch.zeros((0, 3), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
        t(np.array([1, 2, TS_MAX], np.int32)))
    assert out.shape == (3, 7, 3) and not found.any() and not out.any()


# ---------------------------------------------------------------------------
# chain decode
# ---------------------------------------------------------------------------

def chain(rng, c, w, lo, hi, dtype):
    deltas = rng.integers(lo, hi, (c, w)).astype(dtype)
    heads = rng.random(c) < 0.2
    heads[0] = True
    return deltas, heads


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_chain_decode_matches_jax_with_wraparound(dtype, rng):
    info = np.iinfo(dtype)
    deltas, heads = chain(rng, 64, 2, info.min, info.max, dtype)
    if dtype == np.int32:  # long chains of huge deltas wrap int32 often
        heads[1:] = False
        heads[40] = True
    got = tops.chain_decode(t(deltas), t(heads))
    assert got.dtype == torch.int32
    want = np.asarray(jops.chain_decode(jnp.asarray(deltas), jnp.asarray(heads)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), tref.ref_chain_decode(deltas, heads))


@pytest.mark.parametrize("stored", ["int16", "uint16"])
def test_chain_decode_truncates_like_jax(stored, rng):
    """A packed gather decodes in int32, then truncates to the stored
    width; uint16 values read back through the int16 bit view."""
    vals = rng.integers(np.iinfo(stored).min, np.iinfo(stored).max, (64, 2),
                        endpoint=True).astype(stored)
    heads = np.zeros(64, bool)
    heads[[0, 20, 41]] = True
    prev = np.roll(vals, 1, axis=0)
    prev[heads] = 0
    with np.errstate(over="ignore"):
        deltas = vals - prev  # wraps in the stored dtype
    decoded = tops.chain_decode(t(_compat.bits_view(deltas)), t(heads))
    got = _compat.from_bits(_compat.truncate_bits(decoded, 2), np.dtype(stored))
    jdec = jops.chain_decode(jnp.asarray(deltas), jnp.asarray(heads))
    assert np.array_equal(got, np.asarray(jdec.astype(stored)))
    assert np.array_equal(got, vals)


def test_chain_decode_xor_matches_jax(rng):
    deltas, heads = chain(rng, 64, 2, I32.min, I32.max, np.int32)
    heads[0] = False  # a run before the first head scans from cell 0
    got = tops.chain_decode(t(deltas), t(heads), xor=True)
    want = np.asarray(jops.chain_decode(jnp.asarray(deltas), jnp.asarray(heads),
                                        xor=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          tref.ref_chain_decode(deltas, heads, xor=True))


def test_narrow_dtype_matches_jax():
    for m in (0, 127, 128, 32767, 32768, 2**31 - 1, 2**31):
        assert np.dtype(tops.narrow_dtype(m)) == np.dtype(jops.narrow_dtype(m))


# ---------------------------------------------------------------------------
# compaction rewrite and its keep mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 1023, 1025, 3000])
def test_keep_mask_matches_jax_kernel(c, rng):
    """The mask equals the Pallas kernel's. Its per-tile counts do too,
    except that the JAX launch zero-pads the ragged last tile and so counts
    the padding as survivors when cutoff < 0 (harmless there: compact()
    never reads the counts); the port masks the ragged tile instead."""
    ts = rng.integers(-100, 100, c).astype(np.int32)
    tile = tops.launch.tile_for("compact_rewrite", n=c, device="cpu")
    pad = -c % tile
    for cutoff in (-(2**31) + 1, 0, 57, TS_MAX):
        keep, counts = tops.keep_mask(t(ts), cutoff)
        jkeep, jcounts = jcompact._keep_mask(jnp.asarray(ts), cutoff=cutoff,
                                             interpret=True, tile=tile)
        assert np.array_equal(keep.numpy(), np.asarray(jkeep))
        want = np.array(jcounts)
        want[-1] -= pad if 0 > cutoff else 0
        assert np.array_equal(counts.numpy(), want)
        assert counts.sum() == keep.sum()


@pytest.mark.parametrize("dtype", ["int32", "float32", "uint16", "int8"])
def test_compact_rewrite_matches_jax(dtype, rng):
    vals, tss, ptr = mk_csr_log(rng, 30, 200, width=2)
    vals = vals.astype(dtype)
    tss = tss.astype(np.int64)
    n_rows = 30
    for before in (-1, 40, 99, 10**12):
        tq = min(before, TS_MAX)
        out, found = tref.ref_version_select(t(vals.view(_compat.bits_view(vals).dtype)),
                                             t(tss.astype(np.int32)), t(ptr), tq)
        base_vals = _compat.from_bits(out, vals.dtype)
        base_found = found.numpy()
        args = (vals, tss, ptr, base_vals, base_found, before, n_rows)
        got = tops.compact_rewrite(*args, device="cpu")
        for want in (jops.compact_rewrite(*args),
                     jops.compact_rewrite(*args, interpret=True),
                     tops.ref_compact_rewrite(*args)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# wrapper contracts: no quiet fallback, no CUDA by accident
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_inputs():
    ok = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.fingerprint(ok.t())  # not contiguous
    with pytest.raises(ValueError):
        tops.fingerprint(ok.to(torch.int64))
    with pytest.raises(ValueError):
        tops.batched_masked_cumsum(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA card
        tops.keep_mask(torch.zeros(4, dtype=torch.int32, device="meta"), 0)
    with pytest.raises(TypeError):
        tops.fingerprint(np.zeros((2, 2), np.int32))


def test_cpu_tensors_count_no_launches(rng):
    before = {k: fn.launches for k, fn in tops.KERNELS.items()}
    tops.fingerprint(t(extreme_lanes(rng, 5, 3)))
    tops.batched_masked_cumsum(t(np.arange(9, dtype=np.int32)), t(QUERIES))
    tops.keep_mask(t(np.arange(9, dtype=np.int32)), 3)
    assert {k: fn.launches for k, fn in tops.KERNELS.items()} == before


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _compat.resolve_device(None)
    with pytest.raises(RuntimeError):
        _compat.resolve_device("cuda")
    assert _compat.resolve_device("cpu") == torch.device("cpu")


def test_build_needs_nvcc_and_builds_nothing_here(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert not (tmp_path / "b").exists()
    # the build directory is keyed on the sources: stable across calls
    assert _build.build_dir() == _build.build_dir()
