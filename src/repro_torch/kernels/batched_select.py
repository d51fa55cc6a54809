"""Batched masked cumsum: one launch scans the fused log for MANY versions.

Materializing Q pinned versions of a store needs, for every cell log, the
running count of cells with ``ts <= t_q`` for each query; the store reads
it at the CSR row boundaries. ``batched_masked_cumsum`` computes all Q
rows in one launch of the CUDA kernel ``csrc/masked_cumsum.cu``, a single
pass with decoupled look-back that writes each output value once. The
plain version is ``ref.ref_batched_masked_cumsum``.

The stacked form serves a sharded store under a parallel placement
(``core/placement.py``): ``stacked_masked_cumsum`` scans S shards' fused
ts rows, stacked (S, C) and padded with int32 max, for Q queries in the
same one launch (each row's tiles scan on their own), and
``stacked_boundary_select`` samples the result at each shard's CSR
boundaries. Plain versions: ``ref.ref_stacked_masked_cumsum`` and
``ref.ref_stacked_boundary_select``. The JAX package's
``scan_cache_size`` counts jit-compiled executables; the port compiles
nothing per shape, so it has no counterpart.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build, ref
from ._compat import cdiv, check_tensor, count_launch, stream_ptr
from .launch import pow2_bucket, tile_for

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p]
#: cells of a scan tile: ``kTile`` of csrc/masked_cumsum.cu, which refuses
#: a tile count made with any other
TILE = 8192
_MAX_CELLS = 2**31 - 1  # counts are int32


def scan_bucket(n: int) -> int:
    """Power-of-two cell bucket of the fused ts array, floored at the
    resolved ``batched_select`` tile, the JAX package's scan tile (the
    store sizes its device ts buffer with it, like the JAX package, so
    under one environment both report the same device bytes). The
    kernel's own tile stays ``TILE``."""
    return pow2_bucket(n, floor=tile_for("batched_select"))


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How one scan of S rows x C cells x Q queries launches: ``n_tiles``
    tiles a row, and a workspace of ``workspace_words`` 8-byte words (a
    status word per (row, query, tile), then the ticket counter)."""
    n_tiles: int
    workspace_words: int


@functools.lru_cache(maxsize=256)
def scan_plan(s: int, c: int, q: int) -> ScanPlan:
    """The launch plan of a scan. Raises ValueError where counts could pass
    int32 or where the tiles exceed the grid."""
    if c > _MAX_CELLS:
        raise ValueError(f"{c} cells overflow the int32 counts")
    n_tiles = cdiv(c, TILE)
    if s * n_tiles > 2**31 - 1:
        raise ValueError(f"{s} x {n_tiles} tiles exceed the grid")
    return ScanPlan(n_tiles, s * q * n_tiles + 1)


def _check_queries(ts: torch.Tensor, t_queries: torch.Tensor) -> None:
    check_tensor(t_queries, "t_queries", torch.int32, 1)
    if t_queries.device != ts.device:
        raise ValueError(f"t_queries on {t_queries.device}, ts on "
                         f"{ts.device}")


def _scan_rows(ts: torch.Tensor, t_queries: torch.Tensor, s: int, c: int,
               out_shape: tuple) -> torch.Tensor:
    """The CUDA kernel on S rows of C cells (ts on a card, contiguous) ->
    ``out_shape`` = (S, Q, C), or (Q, C) for one row. One output
    allocation, one workspace allocation, one launch; at Q = 1 the host's
    part of the call is as long as the card's, so it touches each tensor
    property once."""
    q = t_queries.shape[0]
    out = ts.new_empty(out_shape)
    if out.numel() == 0:
        return out
    plan = scan_plan(s, c, q)
    # int32 pairs: the 8-byte status words
    ws = ts.new_empty(2 * plan.workspace_words)
    # built and loaded on first use, then a dict lookup
    launch = _build.kernel_fn("masked_cumsum", "masked_cumsum_launch", _ARGS)
    dev = ts.get_device()
    args = (ts.data_ptr(), s, c, t_queries.data_ptr(), q, plan.n_tiles,
            ws.data_ptr(), out.data_ptr(), stream_ptr(dev))
    if dev == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = launch(*args)
    _build.check(rc, "masked_cumsum", "masked_cumsum_launch")
    return out


def batched_masked_cumsum(ts: torch.Tensor,
                          t_queries: torch.Tensor) -> torch.Tensor:
    """ts: (C,) int32; t_queries: (Q,) int32 on the same device -> (Q, C) int32
    inclusive cumsum of (ts <= t_q) per query.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the call in ``batched_masked_cumsum.launches``, and
    in ``by_design["single_query"]`` or ``["batched"]`` by Q)."""
    check_tensor(ts, "ts", torch.int32, 1)
    _check_queries(ts, t_queries)
    if not ts.is_cuda:
        return ref.ref_batched_masked_cumsum(ts, t_queries)
    out = _scan_rows(ts, t_queries, 1, ts.shape[0],
                     (t_queries.shape[0], ts.shape[0]))
    if out.numel():
        count_launch(batched_masked_cumsum, "single_query"
                     if t_queries.shape[0] == 1 else "batched")
    return out


batched_masked_cumsum.launches = 0
batched_masked_cumsum.by_design = {"single_query": 0, "batched": 0}


def stacked_masked_cumsum(ts_stack: torch.Tensor,
                          t_queries: torch.Tensor) -> torch.Tensor:
    """ts_stack: (S, C) int32; t_queries: (Q,) int32 on the same device
    -> (S, Q, C) int32 inclusive cumsum
    of (ts <= t_q) per (shard, query), all shards in one launch. Pad rows
    and ragged tails with int32 max: padding cells never count.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the call in ``stacked_masked_cumsum.launches``)."""
    check_tensor(ts_stack, "ts_stack", torch.int32, 2)
    _check_queries(ts_stack, t_queries)
    if not ts_stack.is_cuda:
        return ref.ref_stacked_masked_cumsum(ts_stack, t_queries)
    s, c = ts_stack.shape
    out = _scan_rows(ts_stack, t_queries, s, c, (s, t_queries.shape[0], c))
    if out.numel():
        count_launch(stacked_masked_cumsum)
    return out


stacked_masked_cumsum.launches = 0


def _boundary_take(cum: torch.Tensor,
                   boundaries: torch.Tensor) -> torch.Tensor:
    """Sample an (S, Q, C) stacked cumsum at per-shard CSR boundaries
    (S, B) -> (S, Q, B); boundary 0 reads count 0. Reads ``cum`` at
    ``boundary - 1`` and zeroes the boundary-0 columns, which equals the
    JAX package's take from a zero-prepended copy without making one."""
    s, q, c = cum.shape
    b = boundaries.shape[1]
    if c == 0:  # every boundary is 0
        return torch.zeros((s, q, b), dtype=torch.int32, device=cum.device)
    idx = (boundaries.long() - 1).clamp_(min=0)
    out = torch.gather(cum, 2, idx[:, None, :].expand(s, q, b))
    return out.masked_fill_((boundaries == 0)[:, None, :], 0)


def stacked_boundary_select(ts_stack: torch.Tensor, t_queries: torch.Tensor,
                            boundaries: torch.Tensor) -> torch.Tensor:
    """Batched select over S stacked fused superlogs, on the device that
    holds the operands.

    ts_stack: (S, Cmax) int32 fused per-shard ts rows padded with int32
    max; t_queries: (Q,) int32 clamped query timestamps; boundaries:
    (S, Bmax) int32 per-shard CSR boundary positions (zero-padded).
    Returns the (S, Q, Bmax) boundary cumsums, every shard's
    ``_SuperLog.boundary_cums`` numbers, from one stacked scan. Placing
    shards on several cards is the caller's part (``core/placement.py``
    runs one call per card)."""
    check_tensor(boundaries, "boundaries", torch.int32, 2)
    if boundaries.device != ts_stack.device:
        raise ValueError(f"boundaries on {boundaries.device}, ts_stack on "
                         f"{ts_stack.device}")
    if boundaries.shape[0] != ts_stack.shape[0]:
        raise ValueError(f"{boundaries.shape[0]} boundary rows for "
                         f"{ts_stack.shape[0]} shards")
    return _boundary_take(stacked_masked_cumsum(ts_stack, t_queries),
                          boundaries)


def batched_version_select(log_vals: torch.Tensor, log_ts: torch.Tensor,
                           row_ptr: torch.Tensor, t_queries: torch.Tensor):
    """Segmented last-cell-with-ts<=T selection for Q query timestamps.

    log_vals: (C, W); log_ts: (C,) int32 ascending within each row
    segment; row_ptr: (N+1,) CSR offsets; t_queries: (Q,) int32. Returns
    (out (Q, N, W), found (Q, N) bool); rows without a cell at t_q are
    zero. One batched scan serves every query."""
    (q,) = t_queries.shape
    n = row_ptr.shape[0] - 1
    dev = log_vals.device
    if log_ts.shape[0] == 0:  # empty log: nothing found anywhere
        return (torch.zeros((q, n) + tuple(log_vals.shape[1:]),
                            dtype=log_vals.dtype, device=dev),
                torch.zeros((q, n), dtype=torch.bool, device=dev))
    cum = batched_masked_cumsum(log_ts, t_queries)
    cum0 = torch.cat([cum.new_zeros((q, 1)), cum], dim=1)
    lo = row_ptr[:-1].long()
    hi = row_ptr[1:].long()
    cnt = cum0[:, hi] - cum0[:, lo]
    found = cnt > 0
    idx = torch.clamp(lo[None, :] + cnt - 1, 0, log_ts.shape[0] - 1)
    out = log_vals[idx]
    out[~found] = 0
    return out, found
