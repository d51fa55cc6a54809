"""The port's masked merge against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.ops.masked_merge`` (the
Pallas body with ``interpret=True``) and ``ref.ref_masked_merge``, and
through ``repro_torch.kernels.ops.masked_merge``, whose wrapper takes its
plain torch version for CPU tensors (the CUDA kernel is held against it
on the card by ``chip_smoke.py``). A select moves bits, so every result
must be equal bit for bit, NaN payloads included.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import masked_merge as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from chip_smoke import at_offset  # noqa: E402

DTYPES = ("int8", "int16", "int32", "float32")


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def inputs(rng, n, w, dtype):
    """(base, upd, row mask, field mask, ts) with the dtype's extremes
    (ints) or NaNs with distinct payloads, -0.0 and infinities (floats),
    and timestamps below 2**31."""
    dt = np.dtype(dtype)
    if dt.kind == "i":
        info = np.iinfo(dt)
        base = rng.integers(info.min, info.max, (n, w), dtype=dt,
                            endpoint=True)
        upd = rng.integers(info.min, info.max, (n, w), dtype=dt,
                           endpoint=True)
    else:
        base = rng.normal(size=(n, w)).astype(dt)
        upd = rng.normal(size=(n, w)).astype(dt)
        bits = upd.view(np.uint32)
        bits.flat[::3] = 0x7FC00000 | rng.integers(1, 1 << 22, bits.flat[::3]
                                                   .shape, dtype=np.uint32)
        upd.flat[1::7] = -0.0
        base.flat[::5] = np.inf
        base.view(np.uint32).flat[2::11] = 0xFFC01234  # negative NaN
    rm = rng.random(n) < 0.4
    fm = rng.random(w) < 0.7
    ts = rng.integers(0, 2**31 - 1, n).astype(np.int64)
    return base, upd, rm, fm, ts


def jax_merge(base, upd, rm, fm, ts, ts_new, interpret):
    args = (jnp.asarray(base), jnp.asarray(upd), jnp.asarray(rm),
            jnp.asarray(fm), jnp.asarray(ts), ts_new)
    if interpret:
        out = jops.masked_merge(*args, interpret=True)
    else:
        out = jref.ref_masked_merge(*args)
    return np.asarray(out[0]), np.asarray(out[1])


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_merge_matches_pallas_body_and_ref(dtype):
    """The sweep of the JAX package's property test (n 1-600, w 1-9,
    seeded), at each value dtype: bit for bit against the Pallas body and
    the JAX ref."""
    rng = np.random.default_rng(0)
    cases = [(1, 1), (600, 9), (511, 3), (513, 1)] + [
        (int(rng.integers(1, 601)), int(rng.integers(1, 10)))
        for _ in range(4)]
    for n, w in cases:
        base, upd, rm, fm, ts = inputs(rng, n, w, dtype)
        ts_new = int(rng.integers(0, 2**31 - 1))
        got = tops.masked_merge(t(base), t(upd), t(rm), t(fm), t(ts), ts_new)
        assert got[1].dtype == torch.int64
        g0, g1 = got[0].numpy(), got[1].numpy()
        for interpret in (True, False):
            w0, w1 = jax_merge(base, upd, rm, fm, ts, ts_new, interpret)
            assert same_bits(g0, w0), (dtype, n, w, interpret)
            # the JAX package narrows int64 ts to int32 (no 64-bit types)
            assert np.array_equal(g1, w1.astype(np.int64)), (n, w)


@pytest.mark.parametrize("ts_dtype", [torch.int32, torch.int64])
def test_masked_merge_keeps_ts_dtype_and_every_width(ts_dtype):
    """Every element width the kernel takes (1, 2, 4, 8 bytes, bool and
    float64 included), int32 and int64 timestamps (int64 beyond 2**31
    too), against a numpy select."""
    rng = np.random.default_rng(1)
    for dtype in ("bool", "uint8", "float16", "uint16", "float64", "int64",
                  "uint32"):
        n, w = 37, 5
        raw = rng.integers(0, 256, (2, n, w * np.dtype(dtype).itemsize),
                           dtype=np.uint8)
        base, upd = (np.ascontiguousarray(r).view(dtype) for r in raw)
        if dtype == "bool":
            base, upd = raw[0, :, :w] & 1 == 1, raw[1, :, :w] & 1 == 1
        rm, fm = rng.random(n) < 0.5, rng.random(w) < 0.5
        big = 2**40 if ts_dtype == torch.int64 else 2**31 - 1
        ts = torch.as_tensor(rng.integers(0, big, n), dtype=ts_dtype)
        merged, ts_out = tops.masked_merge(t(base), t(upd), t(rm), t(fm),
                                           ts, big - 1)
        want = np.where(rm[:, None] & fm[None, :], upd, base)
        assert same_bits(merged.numpy(), want), dtype
        assert ts_out.dtype == ts_dtype
        assert np.array_equal(ts_out.numpy(),
                              np.where(rm, big - 1, ts.numpy()))


def test_masked_merge_cpu_counts_no_launch_and_checks_inputs():
    tops.masked_merge.launches = 0
    base = torch.zeros(4, 3, dtype=torch.int32)
    rm, fm = torch.ones(4, dtype=torch.bool), torch.ones(3, dtype=torch.bool)
    ts = torch.zeros(4, dtype=torch.int32)
    merged, ts_out = tops.masked_merge(base, base + 1, rm, fm, ts, 9)
    assert tops.masked_merge.launches == 0
    assert (merged == 1).all() and (ts_out == 9).all()
    assert tops.KERNELS["masked_merge"] is tops.masked_merge
    with pytest.raises(ValueError):
        tops.masked_merge(base, base.to(torch.int64), rm, fm, ts, 9)
    with pytest.raises(ValueError):
        tops.masked_merge(base, base, rm.to(torch.int32), fm, ts, 9)
    with pytest.raises(ValueError):
        tops.masked_merge(base, base, rm, fm, ts, 2**31)
    with pytest.raises(ValueError):
        tops.masked_merge(base, base, rm, fm, ts.to(torch.int16), 9)
    assert tref.ref_masked_merge(base, base, rm, fm, ts, 3)[1].dtype == \
        torch.int32


@pytest.mark.parametrize("dtype,w,off_base,off_upd,vec_bytes", [
    (torch.int32, 64, 0, 0, 16),    # the head-table merge: 16 units a row
    (torch.int32, 4, 0, 0, 16),
    (torch.int32, 2, 0, 0, 8),      # rows of 8 bytes
    (torch.int32, 3, 0, 0, 4),      # 12 bytes: no 8- or 16-byte unit
    (torch.int32, 64, 4, 4, 4),     # 4 bytes past a 16-byte boundary
    (torch.int32, 64, 8, 8, 8),
    (torch.int32, 64, 0, 8, 8),     # the less aligned operand decides
    (torch.int8, 16, 0, 0, 16),
    (torch.int8, 48, 0, 0, 16),
    (torch.int8, 6, 0, 0, 2),
    (torch.int8, 3, 0, 0, 1),       # one element
    (torch.int8, 64, 1, 1, 1),
    (torch.float16, 12, 0, 0, 8),
    (torch.float64, 2, 0, 0, 16),
    (torch.float64, 3, 0, 0, 8),
    (torch.float64, 2, 8, 8, 8),
    (torch.int64, 1, 0, 0, 8),
])
def test_merge_plan(dtype, w, off_base, off_upd, vec_bytes):
    """Each thread's unit: the widest of 16/8/4/2 bytes (or one element)
    that divides a row's W * s bytes and to which both operands are
    aligned; a block's rows make UNITS_PER_BLOCK units."""
    base = at_offset(torch.zeros((7, w), dtype=dtype), off_base)
    upd = at_offset(torch.zeros((7, w), dtype=dtype), off_upd)
    plan = tmm.merge_plan(base, upd)
    assert plan.vec_bytes == vec_bytes
    assert plan.threads == tmm.THREADS and plan.threads % 32 == 0
    units = w * base.element_size() // vec_bytes
    assert plan.rows_per_block == max(1, tmm.UNITS_PER_BLOCK // units)
    assert (w * base.element_size()) % plan.vec_bytes == 0
    assert base.data_ptr() % vec_bytes == upd.data_ptr() % vec_bytes == 0


def test_merge_plan_edges():
    """The head-table merge's plan (570,000 x 64 int32: 128 rows a block
    of 256 threads), a row wider than a block's units, and W = 0."""
    head = torch.zeros((570_000, 64), dtype=torch.int32)
    assert tmm.merge_plan(head, head) == tmm.MergePlan(16, 256, 128)
    wide = torch.zeros((2, 9000), dtype=torch.int32)
    plan = tmm.merge_plan(wide, wide)
    assert plan.vec_bytes == 16 and plan.rows_per_block == 1
    none = torch.zeros((3, 0), dtype=torch.int8)
    empty = tmm.merge_plan(none, none)
    assert empty.rows_per_block <= tmm.MAX_ROWS_PER_BLOCK


@pytest.mark.parametrize("row_kind", ["none", "all", "mixed"])
@pytest.mark.parametrize("field_kind", ["none", "all", "mixed"])
def test_merge_nbytes_matches_a_brute_force_count(row_kind, field_kind):
    """The mask-aware count (one operand element read per output element,
    ts_base only for rows that keep theirs) and the both-operands count,
    element by element."""
    rng = np.random.default_rng(3)
    n, w = 37, 9
    rm = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
          "mixed": rng.random(n) < 0.3}[row_kind]
    fm = {"none": np.zeros(w, bool), "all": np.ones(w, bool),
          "mixed": rng.random(w) < 0.5}[field_kind]
    for s, t_size in ((1, 4), (4, 8), (8, 8)):
        aware = both = n + w  # the masks
        for r in range(n):
            for f in range(w):
                aware += s + s  # the selected operand's element, the output
                both += 3 * s
            aware += (0 if rm[r] else t_size) + t_size
            both += 2 * t_size
        got = tmm.merge_nbytes(t(rm), t(fm), s, t_size)
        assert got == {"mask_aware": aware, "both_operands": both}
    # the head-table merge: about 3% of 570,000 rows merged, W 64 int32,
    # int64 timestamps
    rm = np.zeros(570_000, bool)
    rm[::33] = True
    got = tmm.merge_nbytes(t(rm), t(np.ones(64, bool)), 4, 8)
    assert got["both_operands"] - got["mask_aware"] == (
        570_000 * 64 * 4 + int(rm.sum()) * 8)
