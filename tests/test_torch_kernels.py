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
    tile = tops.launch.tile_for("keep_mask")
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
