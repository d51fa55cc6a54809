"""The delta codec: elementwise pack/unpack kernels, the on-disk chain
codec built on them, and chain decode on the device.

The store keeps a set of database versions with delta compression (HBase
timestamped cells + Snappy in the paper). On-disk cell segments store, for
each updated row, the delta against the row's previous value: arithmetic
difference for integer fields and bitwise XOR for float fields (unchanged
exponent and mantissa bytes zero out, which the segment files' deflate
exploits).

The elementwise ops are the CUDA kernel ``csrc/delta_codec.cu``:
``delta_pack`` / ``delta_unpack`` on 1-, 2- and 4-byte lanes, with one
int32 stat per tile of ``tile_for("delta_codec", N)`` rows, 512 unless
``GESTORE_TILE_DELTA_CODEC`` or a winner says otherwise (max |delta| for
ints, the nonzero count for float XOR), and ``delta_pack_wide`` /
``delta_unpack_wide`` on 8-byte
lanes (native int64 on Hopper, where the JAX package split each value into
two int32 lanes). A CPU tensor takes the plain torch version in ``ref``; a
CUDA tensor launches the kernel (and counts the launch on the wrapper's
``launches``) or raises.

On-disk chain format (``core/segments.py`` segment files): cells are
sorted by (row, ts); within each row's run ("chain") the first cell is
packed against zero (stored raw) and every later cell against its
predecessor. Chains never cross a segment, so every segment decodes on its
own, which is what makes lazy loading possible. ``chain_pack`` packs on the
given device and narrows on the host; ``chain_unpack`` is a host numpy
depth loop, as in the JAX package. Both write the same bytes as the JAX
package's ``chain_pack`` / ``chain_unpack``.

``chain_decode`` is the device inverse of the same chain format for the
fused superlog: integer fields stay chain-delta-packed on the device and
decode inside the gather path (core/store.py). The JAX package leaves this
scan to XLA (``jax.lax.associative_scan``) over the whole field and then
takes the gathered cells. The port's gather calls ``chain_decode_at``, the
CUDA kernel ``csrc/chain_decode.cu``, which decodes only the gathered cells
(each walks back to its chain's head) and never writes the decoded field.
``chain_decode`` (torch ops) stays as the plain full decode; the plain
``chain_decode_at``, ``ref_chain_decode_at``, is that decode, the take and
the truncation.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..obs import kerneltel
from . import _build, ref
from ._compat import (bits_view, cdiv, check_tensor, count_launch,
                      from_bits, resolve_device, round_up, stream_ptr,
                      truncate_bits)
from .launch import ENV_PREFIX, tile_for

# a, b, out, stats, the launch's static args, the stream
_ARGS = [ctypes.c_void_p] * 6
_BLOCK = 128  # threads per block (chain decode)
CHUNK_BYTES = 16384  # bytes of each operand that one codec block streams
VEC_BYTES = 16       # the codec kernel's vector loads and stores
BLOCK_THREADS = 1024  # a codec block alone: one vector per thread
CLUSTER_THREADS = 256  # a block of a cluster
MAX_BLOCKS_PER_TILE = 8  # in a cluster (the portable cluster size)
_OPS = {"sub": 0, "add": 1, "xor": 2}
_STATS = {"none": 0, "maxabs": 1, "maxabs_unsigned": 2, "nonzero": 3}
_NARROW = (torch.int8, torch.int16, torch.int32, torch.float16,
           torch.bfloat16, torch.float32)
_WIDE = (torch.int64, torch.float64)


def _check_pair(a, b, names: str, dtypes) -> None:
    na, nb = names.split(",")
    for t, name in ((a, na), (b, nb)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.ndim != 2 or t.dtype not in dtypes:
            raise ValueError(f"{name} must be 2-D of {dtypes}, got "
                             f"{t.ndim}-D {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} is on {t.device}; only cpu and cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"{na} and {nb} differ: {tuple(a.shape)} {a.dtype} "
                         f"{a.device} vs {tuple(b.shape)} {b.dtype} "
                         f"{b.device}")


INT32_MIN = -(2**31)
#: each stat's identity, where a tile's word starts
IDENTITY = {"maxabs": INT32_MIN, "maxabs_unsigned": INT32_MIN,
            "nonzero": 0, "none": 0}


@dataclasses.dataclass(frozen=True)
class CodecPlan:
    """The codec kernel's launch geometry for one (N, W, itemsize, stat):
    ``blocks_per_tile`` blocks of ``chunk`` lanes and ``threads`` threads
    cover each stat tile's flat range (tile rows * W lanes), the last
    chunk of a ragged tile short or empty. Where a tile with a stat takes
    several blocks (``cluster``), they form one thread block cluster and
    each folds its partial stat into the tile's word (atomic max, or add
    for the count), which starts at ``identity``."""
    n_tiles: int
    blocks_per_tile: int
    chunk: int
    threads: int
    cluster: bool
    identity: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.blocks_per_tile


def codec_plan(n: int, w: int, itemsize: int, stat: str,
               tile: int | None = None) -> CodecPlan:
    """Chunks of at most ``CHUNK_BYTES`` of each operand, a whole number
    of 16-byte vectors, as few per tile as cover it; a block alone has up
    to ``BLOCK_THREADS`` threads, one vector of each operand per thread.
    A tile with a stat that needs more than one chunk is a cluster of at
    most ``MAX_BLOCKS_PER_TILE`` blocks of ``CLUSTER_THREADS``: at W = 64
    int32 a 512-row tile is 8 blocks of 4,096 lanes, so the grid is many
    waves of small blocks instead of one block per 128 KB tile. (Timed on
    the card, clusters of larger blocks streamed slower.) ``tile``: rows
    per stat tile (None: ``tile_for("delta_codec")``); a tile whose chunks
    pass the kernel's int32 lane count raises."""
    tile = tile or tile_for("delta_codec")
    lanes = tile * w
    bpt = max(1, cdiv(lanes * itemsize, CHUNK_BYTES))
    cluster = stat != "none" and bpt > 1
    if cluster:
        bpt = min(bpt, MAX_BLOCKS_PER_TILE)
    chunk = round_up(cdiv(lanes, bpt), VEC_BYTES // itemsize)
    threads = (CLUSTER_THREADS if cluster else
               min(BLOCK_THREADS, round_up(cdiv(chunk * itemsize, VEC_BYTES),
                                           32)))
    if chunk >= 2**31 or cdiv(n, tile) * cdiv(lanes, chunk) >= 2**31:
        raise ValueError(f"delta_codec: cannot launch a tile of {tile} rows "
                         f"at W {w} (chunks of {chunk} lanes); set "
                         f"{ENV_PREFIX}DELTA_CODEC to a smaller tile")
    return CodecPlan(cdiv(n, tile), cdiv(lanes, chunk), chunk, threads,
                     cluster, IDENTITY[stat])


def _aligned_like(a: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous tensor of ``a``'s shape and dtype whose
    base has ``a``'s address mod 16, so that the kernel's 16-byte vectors
    line up across a, b and out (a view into a slightly larger buffer)."""
    shift = (a.data_ptr() % VEC_BYTES) // a.element_size()
    if shift == 0:
        return torch.empty_like(a)
    buf = torch.empty(a.numel() + VEC_BYTES // a.element_size(),
                      dtype=a.dtype, device=a.device)
    return buf[shift:shift + a.numel()].view(a.shape)


def _run(wrapper, a, b, op: str, stat: str, *, unsigned: bool = False):
    """(a op b, per-tile stat): the plain version for CPU tensors, the
    kernel for CUDA tensors (counted on ``wrapper.launches``)."""
    tile = tile_for("delta_codec", n=a.shape[0], device=a.device)
    if a.is_cpu:
        out = ref.ref_codec(a, b, op)
        return out, ref.ref_tile_stat(out, tile, stat, unsigned=unsigned)
    n, w = a.shape
    out = _aligned_like(a)
    stats = torch.empty(cdiv(n, tile), dtype=torch.int32, device=a.device)
    if n == 0 or w == 0:
        return out, stats.zero_()
    kind = ("maxabs_unsigned" if stat == "maxabs" and unsigned else stat)
    args = _launch_args(n, w, a.element_size(), op, kind, tile)
    fn = _build.kernel_fn("delta_codec", "delta_codec_launch", _ARGS)
    here = a.get_device() == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), stats.data_ptr(),
                args, stream_ptr(a))
    _build.check(rc, "delta_codec", "delta_codec_launch")
    count_launch(wrapper)
    return out, stats


@functools.lru_cache(maxsize=256)
def _launch_args(n: int, w: int, itemsize: int, op: str, kind: str,
                 tile: int):
    """The launcher's static args as one long long array: n, W, itemsize,
    op, stat, tile rows, blocks per tile, chunk, identity, threads per
    block (built once per shape and tile)."""
    plan = codec_plan(n, w, itemsize, kind, tile)
    vals = (n, w, itemsize, _OPS[op], _STATS[kind], tile,
            plan.blocks_per_tile, plan.chunk, plan.identity, plan.threads)
    return (ctypes.c_longlong * len(vals))(*vals)


def delta_pack(new: torch.Tensor, old: torch.Tensor, *,
               unsigned: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack (new, old) -> (delta, stat), both (N, W) of one dtype in
    int8/int16/int32/float16/bfloat16/float32.

    Ints: ``delta = new - old`` in wraparound arithmetic, ``stat`` the max
    |delta| of each tile of ``tile_for("delta_codec", N)`` rows widened to
    int32 (zero-extended when ``unsigned``: pass it for the signed bit
    view of a uint8/uint16 field). Floats: ``delta`` the XOR of the bits,
    ``stat`` the count of nonzero lanes per tile. ``stat`` has ceil(N /
    tile) entries; a ragged last tile counts as padded with zero rows.
    8-byte lanes go to :func:`delta_pack_wide`."""
    _check_pair(new, old, "new,old", _NARROW)
    fl = new.is_floating_point()
    a, b = (ref.int_lanes(new), ref.int_lanes(old)) if fl else (new, old)
    d, stat = _run(delta_pack, a, b, "xor" if fl else "sub",
                   "nonzero" if fl else "maxabs", unsigned=unsigned)
    return (d.view(new.dtype) if fl else d), stat


def delta_unpack(delta: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`delta_pack`: ``delta + old`` (wraparound) for
    ints, the XOR of the bits for floats."""
    _check_pair(delta, old, "delta,old", _NARROW)
    fl = delta.is_floating_point()
    a, b = ((ref.int_lanes(delta), ref.int_lanes(old)) if fl
            else (delta, old))
    out, _ = _run(delta_unpack, a, b, "xor" if fl else "add", "none")
    return out.view(delta.dtype) if fl else out


def delta_pack_wide(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """8-byte pack on (N, W) int64 or float64: exact 64-bit modular
    subtract, or the XOR of the bits for float64."""
    _check_pair(new, old, "new,old", _WIDE)
    fl = new.is_floating_point()
    a, b = (new.view(torch.int64), old.view(torch.int64)) if fl else (new, old)
    out, _ = _run(delta_pack_wide, a, b, "xor" if fl else "sub", "none")
    return out.view(new.dtype)


def delta_unpack_wide(delta: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`delta_pack_wide` (64-bit modular add / XOR)."""
    _check_pair(delta, old, "delta,old", _WIDE)
    fl = delta.is_floating_point()
    a, b = ((delta.view(torch.int64), old.view(torch.int64)) if fl
            else (delta, old))
    out, _ = _run(delta_unpack_wide, a, b, "xor" if fl else "add", "none")
    return out.view(delta.dtype)


for _w in (delta_pack, delta_unpack, delta_pack_wide, delta_unpack_wide):
    _w.launches = 0


# -- device-side chain decode (segmented scan) --------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def chain_decode(deltas: torch.Tensor, heads: torch.Tensor, *,
                 xor: bool = False) -> torch.Tensor:
    """Decode chain deltas: deltas (C, W) int lanes where the first cell of
    every chain is raw and ``heads`` (C,) bool flags those cells.

    Add path: the segmented inclusive sum, reset at heads, in int32
    wraparound; the result is int32 and the caller truncates it to the
    stored dtype (which reproduces the JAX package's int32 scan byte for
    byte). It widens to int64, takes one cumsum per lane, and subtracts
    the running sum just before each cell's chain head (found by a cummax
    over the head positions); int64 holds the sums exactly, so the low 32
    bits are the int32 result. ``xor=True``: the segmented XOR scan in the
    lanes' own dtype, by log-step doubling (float lane chains; XOR is its
    own inverse)."""
    c = deltas.shape[0]
    heads = heads.reshape(-1).to(torch.bool)
    if c == 0:
        return deltas.to(deltas.dtype if xor else torch.int32)
    if xor:
        v, f = deltas, heads
        step = 1
        while step < c:
            # cell i absorbs cell i - step unless a head lies in between
            keep = f[step:].view((-1,) + (1,) * (v.ndim - 1))
            v = torch.cat([v[:step],
                           torch.where(keep, v[step:], v[step:] ^ v[:-step])])
            f = torch.cat([f[:step], f[step:] | f[:-step]])
            step *= 2
        return v
    # scan along the innermost dim: torch's scan over the outer dim of a
    # (C, W) tensor runs one thread per column, sequentially over C
    d = deltas.reshape(c, -1).t().to(torch.int64).contiguous()  # (W, C)
    cs = torch.cumsum(d, dim=1)
    pos = torch.arange(c, device=deltas.device)
    head_at, _ = torch.cummax(torch.where(heads, pos, 0), dim=0)
    before = torch.cat([cs.new_zeros((cs.shape[0], 1)), cs[:, :-1]], dim=1)
    out = _wrap32(cs - before[:, head_at])
    return out.t().contiguous().reshape(deltas.shape)


_DECODE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
_PACKED = (torch.int8, torch.int16, torch.int32)
_OUT = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _check_decode_at(deltas, heads, idx, itemsize: int, xor: bool) -> None:
    check_tensor(deltas, "deltas", deltas.dtype, 2)
    if deltas.dtype not in _PACKED:
        raise ValueError(f"deltas must be one of {_PACKED}, got "
                         f"{deltas.dtype}")
    check_tensor(heads, "heads", torch.bool, 1)
    check_tensor(idx, "idx", idx.dtype, 1)
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64, got {idx.dtype}")
    if heads.shape[0] != deltas.shape[0]:
        raise ValueError(f"{heads.shape[0]} head flags for "
                         f"{deltas.shape[0]} cells")
    if heads.device != deltas.device or idx.device != deltas.device:
        raise ValueError(f"deltas on {deltas.device}, heads on "
                         f"{heads.device}, idx on {idx.device}")
    if itemsize not in _OUT:
        raise ValueError(f"itemsize must be 1, 2 or 4, got {itemsize}")
    if xor and itemsize != deltas.element_size():
        raise ValueError(f"the XOR path writes the lanes' own width "
                         f"({deltas.element_size()}), not {itemsize}")
    if deltas.shape[0] == 0 and idx.shape[0]:
        raise IndexError(f"{idx.shape[0]} cells taken from an empty field")


def ref_chain_decode_at(deltas: torch.Tensor, heads: torch.Tensor,
                        idx: torch.Tensor, *, itemsize: int,
                        xor: bool = False) -> torch.Tensor:
    """The plain version of :func:`chain_decode_at`: the full decode
    (:func:`chain_decode`), the take at ``idx`` clamped into [0, C), and
    the truncation to ``itemsize`` bytes."""
    _check_decode_at(deltas, heads, idx, itemsize, xor)
    c, w = deltas.shape
    if idx.shape[0] == 0:
        return torch.empty((0, w), dtype=_OUT[itemsize], device=deltas.device)
    taken = chain_decode(deltas, heads, xor=xor).index_select(
        0, idx.clamp(0, c - 1))
    return taken if xor else truncate_bits(taken, itemsize)


def chain_decode_at(deltas: torch.Tensor, heads: torch.Tensor,
                    idx: torch.Tensor, *, itemsize: int,
                    xor: bool = False) -> torch.Tensor:
    """The chain-decoded cells ``idx`` of a delta-packed field, without
    decoding the rest.

    deltas: (C, W) int8/int16/int32 chain deltas, the first cell of every
    chain raw; heads: (C,) bool flags of those cells (cells before the
    first head form a chain from cell 0); idx: (n,) int32/int64 cell
    indices on the same device, clamped into [0, C). Returns (n, W), the
    signed int of ``itemsize`` bytes, ready for ``from_bits``: the int32
    wraparound sum of each cell's chain prefix truncated to ``itemsize``
    bytes, or with ``xor=True`` its XOR in the lanes' own width
    (``itemsize`` must then be the lanes'). Bit for bit the JAX package's
    ``chain_decode(deltas, heads)[idx]`` cast to the stored dtype.

    A CPU tensor takes the plain version (:func:`ref_chain_decode_at`); a
    CUDA tensor launches the kernel (and counts the launch in
    ``chain_decode_at.launches``)."""
    _check_decode_at(deltas, heads, idx, itemsize, xor)
    if deltas.device.type == "cpu":
        return ref_chain_decode_at(deltas, heads, idx, itemsize=itemsize,
                                   xor=xor)
    plan = decode_at_plan(deltas)
    c, w = deltas.shape
    out = torch.empty((idx.shape[0], w), dtype=_OUT[itemsize],
                      device=deltas.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("chain_decode", "chain_decode_at_launch",
                          _DECODE_ARGS)
    here = deltas.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(
            deltas.device):
        rc = fn(deltas.data_ptr(), heads.data_ptr(), idx.data_ptr(),
                idx.element_size(), idx.shape[0], c, w,
                deltas.element_size(), itemsize, int(xor), plan.vec_bytes,
                plan.group_log2, out.data_ptr(), _BLOCK,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "chain_decode", "chain_decode_at_launch")
    count_launch(chain_decode_at)
    return out


chain_decode_at.launches = 0


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the kernel lays out a gather: each thread takes ``vec_bytes``
    of a row's packed deltas (``lanes`` lanes) per chain cell, and
    ``2 ** group_log2`` threads share one cell."""
    vec_bytes: int
    lanes: int
    group_log2: int

    @property
    def threads_per_cell(self) -> int:
        return 1 << self.group_log2


def decode_at_plan(deltas: torch.Tensor) -> DecodePlan:
    """16-byte chunks where every row starts 16-byte aligned (W * itemsize
    a multiple of 16 and an aligned base), else 4-byte chunks where rows
    start 4-byte aligned, else single lanes; the smallest power-of-two
    group of threads, at most a warp, that covers a row's chunks."""
    s = deltas.element_size()
    w = deltas.shape[1]
    vec = next(v for v in (16, 4, s)
               if v >= s and (w * s) % v == 0 and deltas.data_ptr() % v == 0)
    lanes = vec // s
    return DecodePlan(vec, lanes, min(max(w // lanes - 1, 0).bit_length(), 5))


def narrow_dtype(maxabs: int, base=np.int32) -> type:
    """The narrowest int dtype that holds every delta of magnitude
    <= ``maxabs`` (``base`` when none of int8/16/32 does)."""
    if maxabs < 128:
        return np.int8
    if maxabs < 32768:
        return np.int16
    if maxabs < 2**31:
        return np.int32
    return base


# -- host-facing chain codec (the on-disk segment cell format) ---------------

def _chain_heads(rows: np.ndarray) -> np.ndarray:
    first = np.ones(len(rows), bool)
    first[1:] = rows[1:] != rows[:-1]
    return first


def chain_pack(vals: np.ndarray, rows: np.ndarray, *,
               device=None) -> tuple[np.ndarray, dict]:
    """Delta-pack a (row, ts)-sorted cell run for on-disk storage.

    Args:
      vals: (C, W) host cell values, sorted so equal-row cells are
        adjacent and in ascending ts order within the row ("chains").
      rows: (C,) row index of each cell (defines the chain boundaries).
      device: where the pack runs (None: the CUDA card; ``"cpu"`` takes the
        plain torch version).

    Returns:
      (packed, meta): ``packed`` has the same shape as ``vals``, the first
      cell of each chain raw and later cells as deltas vs their predecessor
      (arithmetic for ints, XOR of the bits for floats). Integer deltas of
      4 or more bytes are narrowed to int8/int16/int32 when the whole run
      allows it. ``meta`` records ``mode`` ("raw" for empty input, else
      "delta"), the original ``dtype`` name, and optionally ``narrow``.
    """
    if len(vals) == 0:
        return vals.copy(), {"mode": "raw", "dtype": vals.dtype.name}
    # traffic model: read new + predecessor cells, write the delta;
    # arithmetic: one sub/xor per element (the stat rides along). The port
    # streams no pad slack, so padded_nbytes is the logical traffic.
    with kerneltel.launch("delta_codec", nbytes=3 * vals.nbytes,
                          flops=vals.size):
        return _chain_pack_timed(vals, rows, resolve_device(device))


def _chain_pack_timed(vals: np.ndarray, rows: np.ndarray,
                      device: torch.device) -> tuple[np.ndarray, dict]:
    vals = np.ascontiguousarray(vals)
    dt = vals.dtype
    flat = vals.reshape(len(vals), -1)
    # floats go up as floats (the wrapper XORs their bits); ints as the
    # signed int of their width, with the signedness passed alongside
    new = torch.as_tensor(flat if dt.kind == "f" else bits_view(flat),
                          device=device)
    # prev on the device: each cell's predecessor, chain heads against zero
    prev = torch.roll(new, 1, 0)
    prev[torch.as_tensor(_chain_heads(rows), device=device)] = 0
    if dt.itemsize == 8:
        d = delta_pack_wide(new, prev)
    else:
        d, _stat = delta_pack(new, prev, unsigned=dt.kind == "u")
    delta = from_bits(d, dt).reshape(vals.shape)
    meta = {"mode": "delta", "dtype": dt.name}
    if np.issubdtype(dt, np.integer) and dt.itemsize >= 4:
        # bound via min/max lifted to Python ints, on the delta in its own
        # dtype: exact for int64-min (where np.abs wraps negative) and for
        # uint32 deltas at or above 2**31
        maxabs = max(-int(delta.min()), int(delta.max())) if delta.size else 0
        narrow = np.dtype(narrow_dtype(
            maxabs, base=np.int64 if dt.itemsize == 8 else np.int32))
        if narrow != dt:
            delta = delta.astype(narrow)
            meta["narrow"] = narrow.name
    return delta, meta


def chain_unpack(packed: np.ndarray, rows: np.ndarray, meta: dict,
                 out_dtype: np.dtype) -> np.ndarray:
    """Invert ``chain_pack`` on the host: reconstruct (C, W) cell values.

    Chains are rebuilt one depth level per pass (chains are short: one
    cell per version the row changed in), so the cost is
    O(cells x max_chain_depth / chain_count) vectorized numpy steps.

    Raises:
      KeyError/TypeError: if ``meta`` does not come from ``chain_pack``.
    """
    if meta["mode"] == "raw" or len(packed) == 0:
        return packed.astype(out_dtype)
    # traffic model mirrors chain_pack's: read delta + predecessor, write
    # the reconstruction; one add/xor per element
    with kerneltel.launch("delta_codec", nbytes=3 * packed.nbytes,
                          flops=packed.size):
        return _chain_unpack_timed(packed, rows, meta, out_dtype)


def _chain_unpack_timed(packed: np.ndarray, rows: np.ndarray, meta: dict,
                        out_dtype: np.dtype) -> np.ndarray:
    stored = np.dtype(meta["dtype"])
    delta = packed.astype(stored) if "narrow" in meta else packed
    out = delta.copy()
    first = _chain_heads(rows)
    starts = np.nonzero(first)[0]
    lens = np.diff(np.append(starts, len(rows)))
    is_float = np.issubdtype(stored, np.floating)
    ib = {8: np.int64, 4: np.int32, 2: np.int16}.get(stored.itemsize, np.int32)
    with np.errstate(over="ignore"):
        for depth in range(1, int(lens.max()) if len(lens) else 0):
            idx = starts[lens > depth] + depth
            if is_float:
                out[idx] = (out[idx].view(ib)
                            ^ out[idx - 1].view(ib)).view(out.dtype)
            else:
                out[idx] = out[idx] + out[idx - 1]
    return out.astype(out_dtype)
