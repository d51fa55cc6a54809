"""Batched masked cumsum: one launch scans the fused log for MANY versions.

Materializing Q pinned versions of a store needs, for every cell log, the
running count of cells with ``ts <= t_q`` for each query; the store reads
it at the CSR row boundaries. ``batched_masked_cumsum`` computes all Q
rows in one call of the CUDA kernel ``csrc/masked_cumsum.cu`` (a counting
pass, torch's cumsum over the small (Q, tiles) count array, and a scan
pass that writes each output value once). The plain version is
``ref.ref_batched_masked_cumsum``.

The stacked form serves a sharded store under a parallel placement
(``core/placement.py``): ``stacked_masked_cumsum`` scans S shards' fused
ts rows, stacked (S, C) and padded with int32 max, for Q queries in the
same launch pair (the kernel's grid has a shard axis), and
``stacked_boundary_select`` samples the result at each shard's CSR
boundaries. Plain versions: ``ref.ref_stacked_masked_cumsum`` and
``ref.ref_stacked_boundary_select``. The JAX package's
``scan_cache_size`` counts jit-compiled executables; the port compiles
nothing per shape, so it has no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._compat import cdiv, check_tensor, count_launch, stream_ptr
from .launch import pow2_bucket, tile_for

_COUNTS_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
_SCAN_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_ITEMS = 4  # cells per thread, as in the kernel
_MAX_ROWS = 65535  # the grid's y extent


def scan_bucket(n: int) -> int:
    """Power-of-two cell bucket of the fused ts array, floored at one scan
    tile (the store sizes its device ts buffer with it, like the JAX
    package, so both report the same device bytes)."""
    return pow2_bucket(n, floor=tile_for("masked_cumsum"))


def _check_queries(ts: torch.Tensor, t_queries: torch.Tensor) -> None:
    check_tensor(t_queries, "t_queries", torch.int32, 1)
    if t_queries.device != ts.device:
        raise ValueError(f"t_queries on {t_queries.device}, ts on "
                         f"{ts.device}")


def _scan_rows(ts: torch.Tensor, t_queries: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on S rows: ts (S, C) int32 on a card -> (S, Q, C)."""
    (s, c), (q,) = ts.shape, t_queries.shape
    out = torch.empty((s, q, c), dtype=torch.int32, device=ts.device)
    if s == 0 or c == 0 or q == 0:
        return out
    if s > _MAX_ROWS:
        raise ValueError(f"{s} rows exceed the grid's {_MAX_ROWS}")
    tile = tile_for("masked_cumsum")
    n_tiles = cdiv(c, tile)
    block = tile // _ITEMS
    counts = torch.empty((s, q, n_tiles), dtype=torch.int32, device=ts.device)
    with torch.cuda.device(ts.device):
        stream = stream_ptr(ts)
        fn = _build.kernel_fn("masked_cumsum", "masked_cumsum_counts",
                              _COUNTS_ARGS)
        rc = fn(ts.data_ptr(), s, c, t_queries.data_ptr(), q,
                counts.data_ptr(), n_tiles, block, stream)
        _build.check(rc, "masked_cumsum", "masked_cumsum_counts")
        # exclusive per-tile offsets; cumsum of int32 promotes to int64
        # unless the dtype is given
        offsets = torch.cumsum(counts, dim=2, dtype=torch.int32) - counts
        fn = _build.kernel_fn("masked_cumsum", "masked_cumsum_scan",
                              _SCAN_ARGS)
        rc = fn(ts.data_ptr(), s, c, t_queries.data_ptr(), q,
                offsets.data_ptr(), n_tiles, out.data_ptr(), block, stream)
        _build.check(rc, "masked_cumsum", "masked_cumsum_scan")
    return out


def batched_masked_cumsum(ts: torch.Tensor,
                          t_queries: torch.Tensor) -> torch.Tensor:
    """ts: (C,) int32; t_queries: (Q,) int32 on the same device ->
    (Q, C) int32 inclusive cumsum of (ts <= t_q) per query.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the call in ``batched_masked_cumsum.launches``)."""
    check_tensor(ts, "ts", torch.int32, 1)
    _check_queries(ts, t_queries)
    if ts.device.type == "cpu":
        return ref.ref_batched_masked_cumsum(ts, t_queries)
    out = _scan_rows(ts[None], t_queries)[0]
    if out.numel():
        count_launch(batched_masked_cumsum)
    return out


batched_masked_cumsum.launches = 0


def stacked_masked_cumsum(ts_stack: torch.Tensor,
                          t_queries: torch.Tensor) -> torch.Tensor:
    """ts_stack: (S, C) int32; t_queries: (Q,) int32 on the same device ->
    (S, Q, C) int32 inclusive cumsum of (ts <= t_q) per (shard, query),
    all shards in one launch pair. Pad rows and ragged tails with int32
    max: padding cells never count.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the call in ``stacked_masked_cumsum.launches``)."""
    check_tensor(ts_stack, "ts_stack", torch.int32, 2)
    _check_queries(ts_stack, t_queries)
    if ts_stack.device.type == "cpu":
        return ref.ref_stacked_masked_cumsum(ts_stack, t_queries)
    out = _scan_rows(ts_stack, t_queries)
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
