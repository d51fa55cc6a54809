"""Chain decode at index, and the scan's launch plan, on the CPU.

``chain_decode_at`` (the gather of every delta-packed superlog field)
must equal, bit for bit, the JAX package's full ``chain_decode`` followed
by the take and the cast to the stored dtype; on the CPU it runs its plain
version, which ``chip_smoke.py`` holds the CUDA kernel
(``csrc/chain_decode.cu``) against on the card. Inputs come from numpy
generators with fixed seeds. The scan's host-side plan (workspace and
tiles) is pinned here too: the single-pass kernel itself runs only on the
card.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.kernels import _compat  # noqa: E402
from repro_torch.kernels import batched_select as tbs  # noqa: E402
from repro_torch.kernels import delta_codec as tdc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from chip_smoke import at_offset, covered_cells  # noqa: E402

# one log shape for the add-path parity cases: the JAX package compiles
# its scan (in int32 whatever the packed width) once per shape, and that
# compile is most of this file's time
C, W = 5_000, 3


def t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def field(rng, packed, c=C, w=W):
    info = np.iinfo(packed)
    deltas = rng.integers(info.min, info.max, (c, w), endpoint=True,
                          dtype=packed)
    heads = rng.random(c) < 0.15
    heads[0] = False  # the cells before the first head chain from cell 0
    return deltas, heads


def edge_idx(rng, heads):
    """Repeated, unsorted, at heads, at cell 0 and at C - 1."""
    c = len(heads)
    at_heads = np.nonzero(heads)[0][:5]
    return np.concatenate([[0, c - 1, 0], at_heads, at_heads,
                           rng.integers(0, c, 40)]).astype(np.int64)


def jax_take(deltas, heads, idx, stored=None, *, xor=False):
    """The JAX package's gather of a packed field: full decode, take,
    cast to the stored dtype (src/repro/core/store.py:405-407)."""
    dec = jops.chain_decode(jnp.asarray(deltas), jnp.asarray(heads), xor=xor)
    if stored is not None:
        dec = dec.astype(stored)
    return np.asarray(jnp.take(dec, jnp.asarray(idx), axis=0))


@pytest.mark.parametrize("stored", ["int16", "uint16", "int32"])
@pytest.mark.parametrize("packed", [np.int8, np.int16, np.int32])
def test_decode_at_matches_jax_take(packed, stored, rng):
    deltas, heads = field(rng, packed)
    idx = edge_idx(rng, heads)
    size = np.dtype(stored).itemsize
    got = tops.chain_decode_at(t(deltas), t(heads), t(idx), itemsize=size)
    assert got.dtype == {2: torch.int16, 4: torch.int32}[size]
    assert got.shape == (len(idx), W)
    want = jax_take(deltas, heads, idx, stored)
    # uint16 values travel as their int16 bit view
    assert np.array_equal(_compat.from_bits(got, np.dtype(stored)), want)


@pytest.mark.parametrize("packed", [np.int8, np.int16, np.int32])
def test_decode_at_xor_matches_jax_take(packed, rng):
    """The XOR path against the JAX scan at int32 lanes (one compile) and
    against the JAX package's host depth loop at every width."""
    deltas, heads = field(rng, packed, c=300)
    idx = edge_idx(rng, heads)
    got = tops.chain_decode_at(t(deltas), t(heads), t(idx),
                               itemsize=np.dtype(packed).itemsize, xor=True)
    assert got.dtype == t(deltas).dtype
    host = jref.ref_chain_decode(deltas, heads, xor=True)[idx]
    assert np.array_equal(got.numpy(), host)
    if packed == np.int32:
        assert np.array_equal(got.numpy(),
                              jax_take(deltas, heads, idx, xor=True))


def test_decode_at_int32_and_int64_indices_agree(rng):
    deltas, heads = field(rng, np.int8)
    idx = edge_idx(rng, heads)
    a = tops.chain_decode_at(t(deltas), t(heads), t(idx), itemsize=4)
    b = tops.chain_decode_at(t(deltas), t(heads), t(idx.astype(np.int32)),
                             itemsize=4)
    assert torch.equal(a, b)


def test_decode_at_empty_index_and_empty_field(rng):
    deltas, heads = field(rng, np.int16)
    got = tops.chain_decode_at(t(deltas), t(heads),
                               torch.zeros(0, dtype=torch.int64), itemsize=4)
    assert got.shape == (0, W) and got.dtype == torch.int32
    empty = tops.chain_decode_at(torch.zeros((0, W), dtype=torch.int8),
                                 torch.zeros(0, dtype=torch.bool),
                                 torch.zeros(0, dtype=torch.int64),
                                 itemsize=2)
    assert empty.shape == (0, W) and empty.dtype == torch.int16
    with pytest.raises(IndexError):
        tops.chain_decode_at(torch.zeros((0, W), dtype=torch.int8),
                             torch.zeros(0, dtype=torch.bool),
                             torch.zeros(1, dtype=torch.int64), itemsize=2)


def test_decode_at_one_long_chain(rng):
    """One chain of all 5,000 cells: every taken cell sums its whole
    prefix in int32 wraparound, far past the JAX scan's log depth."""
    deltas = rng.integers(-(2**31), 2**31 - 1, (C, W), endpoint=True,
                          dtype=np.int32)
    heads = np.zeros(C, bool)
    heads[0] = True
    idx = np.array([C - 1, 0, C // 2, C - 1, 1], np.int64)
    got = tops.chain_decode_at(t(deltas), t(heads), t(idx), itemsize=4)
    assert np.array_equal(got.numpy(), jax_take(deltas, heads, idx, "int32"))
    with np.errstate(over="ignore"):
        last = deltas.sum(axis=0, dtype=np.int32)
    assert np.array_equal(got.numpy()[0], last)


def test_decode_at_clamps_indices_and_checks_arguments(rng):
    deltas, heads = field(rng, np.int8, c=40)
    d, h = t(deltas), t(heads)
    got = tops.chain_decode_at(d, h, t(np.array([-3, 40, 99])), itemsize=4)
    want = tops.chain_decode_at(d, h, t(np.array([0, 39, 39])), itemsize=4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):  # XOR writes the lanes' own width
        tops.chain_decode_at(d, h, t(np.array([1])), itemsize=4, xor=True)
    with pytest.raises(ValueError):
        tops.chain_decode_at(d, h[:-1], t(np.array([1])), itemsize=4)
    with pytest.raises(ValueError):
        tops.chain_decode_at(d, h, t(np.array([1])), itemsize=8)
    with pytest.raises(ValueError):
        tops.chain_decode_at(d.to(torch.int64), h, t(np.array([1])),
                             itemsize=4)


def test_decode_at_plain_is_the_full_decode_then_take(rng):
    """The plain version is today's gather: chain_decode (torch ops), the
    take and truncate_bits; on the CPU it counts no launch."""
    deltas, heads = field(rng, np.int16)
    idx = edge_idx(rng, heads)
    before = tops.chain_decode_at.launches
    got = tops.chain_decode_at(t(deltas), t(heads), t(idx), itemsize=2)
    full = tops.chain_decode(t(deltas), t(heads))
    assert torch.equal(got, _compat.truncate_bits(full[t(idx)], 2))
    assert tops.chain_decode_at.launches == before
    assert tops.KERNELS["chain_decode"] is tops.chain_decode_at


@pytest.mark.parametrize("dtype,w,off,vec_bytes,lanes,group_log2", [
    (torch.int8, 64, 0, 16, 16, 2),   # the sequence field: 4 chunks of 16
    (torch.int8, 8, 0, 4, 4, 1),      # rows of 8 bytes: 4-byte chunks
    (torch.int8, 3, 0, 1, 1, 2),
    (torch.int8, 1, 0, 1, 1, 0),      # the length field
    (torch.int16, 8, 0, 16, 8, 0),    # the annotation field at int16
    (torch.int16, 64, 0, 16, 8, 3),
    (torch.int16, 3, 0, 2, 1, 2),
    (torch.int16, 1, 0, 2, 1, 0),
    (torch.int32, 64, 0, 16, 4, 4),
    (torch.int32, 8, 0, 16, 4, 1),
    (torch.int32, 3, 0, 4, 1, 2),
    (torch.int32, 1, 0, 4, 1, 0),
    (torch.int32, 0, 0, 16, 4, 0),
    # rows whole 16-byte vectors but the base 4 or 8 bytes past one
    (torch.int8, 64, 4, 4, 4, 4),
    (torch.int8, 64, 8, 4, 4, 4),
    (torch.int16, 64, 4, 4, 2, 5),    # 32 chunks: a warp
    (torch.int16, 8, 2, 2, 1, 3),
    (torch.int32, 64, 4, 4, 1, 5),    # 64 single lanes: capped at a warp
    (torch.int32, 8, 8, 4, 1, 3),
])
def test_decode_plan(dtype, w, off, vec_bytes, lanes, group_log2):
    """Packed bytes a thread loads per chain cell (16 on rows of whole
    16-byte vectors at an aligned base, else 4, else one lane), its lanes
    and the threads per cell, at int8/16/32 and W 1/3/8/64."""
    deltas = at_offset(torch.zeros((5, w), dtype=dtype), off)
    plan = tdc.decode_at_plan(deltas)
    assert (plan.vec_bytes, plan.lanes, plan.group_log2) == (
        vec_bytes, lanes, group_log2)
    assert plan.vec_bytes == plan.lanes * deltas.element_size()
    assert deltas.data_ptr() % plan.vec_bytes == 0
    assert w % plan.lanes == 0
    chunks = w // plan.lanes
    assert plan.threads_per_cell == 1 << group_log2 <= 32
    assert plan.threads_per_cell >= min(chunks, 32)


def test_decode_plan_misaligned_rows_take_single_lanes():
    base = torch.zeros(1 + 5 * 64, dtype=torch.int8)
    rows = base[1:].view(5, 64)  # contiguous, one byte past alignment
    assert rows.is_contiguous() and rows.data_ptr() % 4 == 1
    assert tdc.decode_at_plan(rows) == tdc.DecodePlan(1, 1, 5)


# ---------------------------------------------------------------------------
# the kernel's head-window chain-start search, emulated on the host
# ---------------------------------------------------------------------------

MASK64 = (1 << 64) - 1
LOW7 = 0x7F7F7F7F7F7F7F7F
HIGH = 0x8080808080808080


def window_start(mem: np.ndarray, first: int, i: int) -> tuple[int, int]:
    """csrc/chain_decode.cu's chain_start on a byte ``mem`` whose address
    0 is 8-byte aligned and whose cell 0 is at byte ``first``: load the
    aligned 8-byte word that holds cell i, keep the flags at or below i
    and at or after cell 0, take the highest nonzero byte (63 - clzll on
    the bytes' bit 7), else step back a word. Returns (start, words
    loaded)."""
    at = first + i
    word = at & ~7
    keep = MASK64 >> (8 * (7 - (at & 7)))
    loads = 0
    while True:
        if word < first:
            keep &= (MASK64 << (8 * (first - word))) & MASK64
        x = int.from_bytes(mem[word:word + 8].tobytes(), "little") & keep
        loads += 1
        flags = (((x & LOW7) + LOW7) | x) & HIGH
        if flags:
            return word + ((flags.bit_length() - 1) >> 3) - first, loads
        if word <= first:
            return 0, loads
        word -= 8
        keep = MASK64


def random_heads(rng, c, first_head):
    """Chains of 1-20 cells (so they cross the 8-byte words of flags),
    with or without a head at cell 0."""
    heads = np.zeros(c, bool)
    at = 0 if first_head else int(rng.integers(1, 12))
    while at < c:
        heads[at] = True
        at += int(rng.integers(1, 21))
    return heads


@pytest.mark.parametrize("first_head", [True, False])
@pytest.mark.parametrize("first", [0, 1, 5, 7, 8, 13])
def test_window_search_finds_chain_starts(first, first_head, rng):
    """The emulated search against the JAX package's host decode, whose
    decode of unit deltas counts each cell's place in its chain, and the
    chain prefixes it covers against chip_smoke.covered_cells (the
    decode's bound). The bytes around the flags are nonzero, as a view's
    neighbours may be."""
    c = 700
    heads = random_heads(rng, c, first_head)
    mem = rng.integers(1, 256, first + c + 16).astype(np.uint8)
    mem[first:first + c] = heads
    rank = jref.ref_chain_decode(np.ones((c, 1), np.int32), heads)[:, 0]
    want = np.arange(c) + 1 - rank
    got = [window_start(mem, first, i) for i in range(c)]
    assert [g for g, _ in got] == want.tolist()
    # a cell at most 7 past its chain's head costs at most two word loads
    assert all(n <= 2 for i, (s, n) in enumerate(got)
               if i - s < 8 and (s > 0 or heads[0]))
    idx = np.concatenate([[0, c - 1, 0], rng.integers(0, c, 300)])
    ends = {}
    for i in idx:
        s, _ = got[i]
        ends[s] = max(ends.get(s, s), i)
    assert sum(e - s + 1 for s, e in ends.items()) == covered_cells(heads,
                                                                    idx)


def test_window_search_long_chain_and_no_head():
    """A chain far longer than a word (the 10,000-cell edge case) steps
    back a word at a time to its head; with no head anywhere it starts at
    cell 0."""
    c = 10_000
    for first in (0, 3):
        mem = np.zeros(first + c + 16, np.uint8)
        mem[:first] = 1  # flags of another field before cell 0
        assert window_start(mem, first, c - 1) == (0, (first + c - 1) // 8
                                                   + 1)
        mem[first + 1] = 1
        assert window_start(mem, first, c - 1)[0] == 1
        assert window_start(mem, first, 0)[0] == 0


# ---------------------------------------------------------------------------
# the store's packed gather, against the JAX store's
# ---------------------------------------------------------------------------

# every field W wide, every row changed in every release: each field's log
# is (C, W), the shape whose JAX scan the cases above compiled
SCHEMA = [("seq", W, "int32"), ("code", W, "uint16"), ("small", W, "int16")]


def test_store_packed_take_cells_matches_jax(rng, monkeypatch):
    monkeypatch.setenv("GESTORE_PACKED_SUPERLOG", "1")
    js = jstore.VersionedStore("p", [jstore.FieldSchema(*f) for f in SCHEMA])
    ts = tstore.VersionedStore("p", [tstore.FieldSchema(*f) for f in SCHEMA],
                               device="cpu")
    n_rows = C // 5
    keys = [f"K{i:04d}" for i in range(n_rows)]
    # heads are stored raw, so small values let every field narrow
    table = {"seq": rng.integers(-100, 100, (n_rows, W)).astype(np.int32),
             "code": rng.integers(0, 100, (n_rows, W)).astype(np.uint16),
             "small": rng.integers(-50, 50, (n_rows, W)).astype(np.int16)}
    for v in range(5):
        for s in (js, ts):
            s.update((v + 1) * 10, keys, table)
        step = rng.integers(1, 20, (n_rows, W))
        # uint16 deltas narrow only while they grow (a wrapped negative
        # delta is a large uint16)
        table = {"seq": table["seq"] - step.astype(np.int32),
                 "code": table["code"] + step.astype(np.uint16),
                 "small": table["small"] - step.astype(np.int16)}
    jsl, tsl = js.superlog(), ts.superlog()
    for name, _, stored in SCHEMA:
        jf, tf = jsl.fields[name], tsl.fields[name]
        assert tf.packed_host is not None and jf.packed_host is not None
        assert tf.packed_host.shape == (C, W)
        assert np.array_equal(tf.packed_host, jf.packed_host)
        idx = np.concatenate([[0, C - 1, C - 1],
                              rng.integers(0, C, 50)]).astype(np.int32)
        got = _compat.from_bits(tf.take_cells(idx), np.dtype(stored))
        want = np.asarray(jf.take_cells(idx))
        assert want.dtype == np.dtype(stored)
        assert np.array_equal(got, want)
        assert np.array_equal(got, tf.vals_host[idx])


# ---------------------------------------------------------------------------
# the scan's launch plan (the single-pass kernel runs on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,c,q", [(1, 1, 1), (1, 2047, 1), (1, 2048, 1),
                                   (1, 2049, 8), (1, 6_666_179, 1),
                                   (4, 2_097_152, 64), (3, 5001, 2)])
def test_scan_plan_workspace(s, c, q):
    tile = tbs.TILE
    plan = tbs.scan_plan(s, c, q)
    assert plan.n_tiles == -(-c // tile)
    # one status word per (row, query, tile), then the ticket
    assert plan.workspace_words == s * q * plan.n_tiles + 1


def test_scan_plan_limits():
    most = 2**31 - 1
    assert tbs.scan_plan(1, most, 1).n_tiles == -(-most // tbs.TILE)
    with pytest.raises(ValueError):  # counts are int32
        tbs.scan_plan(1, 2**31, 1)
    with pytest.raises(ValueError):  # the tiles exceed the grid
        tbs.scan_plan(2**20, 2**31 - 1, 1)


def test_scan_bucket_keeps_the_jax_floor():
    """The kernel's tile is 8192 cells; the store's device ts buffer is
    still bucketed like the JAX package's, floored at its 2048-cell tile."""
    assert tbs.TILE == 8192
    assert "masked_cumsum" not in tops.launch.DEFAULT_TILES
    for n in (0, 1, 2048, 2049, 8193, 6_666_179):
        assert tops.scan_bucket(n) == jops.scan_bucket(n)


@pytest.mark.parametrize("shape", [(3000,), (2, 3000)])
def test_scan_refuses_queries_off_the_cpu_and_card(shape, rng):
    """The timestamps are a tensor on ts's device: a card's scan reads
    them there, and a device other than the CPU or a card is refused."""
    ts = t(np.sort(rng.integers(0, 50, shape), axis=-1).astype(np.int32))
    qs = t(np.array([5, 25, 49], np.int32)).to(torch.device("meta"))
    scan = (tops.batched_masked_cumsum if len(shape) == 1
            else tops.stacked_masked_cumsum)
    with pytest.raises(ValueError):
        scan(ts, qs)


@pytest.mark.parametrize("shape", [(3000,), (2, 3000)])
def test_scan_on_the_cpu_is_the_plain_version(shape, rng):
    ts = t(np.sort(rng.integers(0, 50, shape), axis=-1).astype(np.int32))
    qs = t(np.array([5, 25, 49], np.int32))
    if len(shape) == 1:
        got = tops.batched_masked_cumsum(ts, qs)
        want = tops.ref.ref_batched_masked_cumsum(ts, qs)
    else:
        got = tops.stacked_masked_cumsum(ts, qs)
        want = tops.ref.ref_stacked_masked_cumsum(ts, qs)
    assert torch.equal(got, want)
