"""Batched masked cumsum: one launch scans the fused log for MANY versions.

Materializing Q pinned versions of a store needs, for every cell log, the
running count of cells with ``ts <= t_q`` for each query; the store reads
it at the CSR row boundaries. ``batched_masked_cumsum`` computes all Q
rows in one call of the CUDA kernel ``csrc/masked_cumsum.cu`` (a counting
pass, torch's cumsum over the small (Q, tiles) count array, and a scan
pass that writes each output value once). The plain version is
``ref.ref_batched_masked_cumsum``. The sharded (stacked) form waits for
the sharding slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._compat import cdiv, check_tensor, stream_ptr
from .launch import pow2_bucket, tile_for

_COUNTS_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
_SCAN_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p]
_ITEMS = 4  # cells per thread, as in the kernel


def scan_bucket(n: int) -> int:
    """Power-of-two cell bucket of the fused ts array, floored at one scan
    tile (the store sizes its device ts buffer with it, like the JAX
    package, so both report the same device bytes)."""
    return pow2_bucket(n, floor=tile_for("masked_cumsum"))


def batched_masked_cumsum(ts: torch.Tensor,
                          t_queries: torch.Tensor) -> torch.Tensor:
    """ts: (C,) int32; t_queries: (Q,) int32 on the same device ->
    (Q, C) int32 inclusive cumsum of (ts <= t_q) per query.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the call in ``batched_masked_cumsum.launches``)."""
    check_tensor(ts, "ts", torch.int32, 1)
    check_tensor(t_queries, "t_queries", torch.int32, 1)
    if t_queries.device != ts.device:
        raise ValueError(f"t_queries on {t_queries.device}, ts on "
                         f"{ts.device}")
    if ts.device.type == "cpu":
        return ref.ref_batched_masked_cumsum(ts, t_queries)
    (c,), (q,) = ts.shape, t_queries.shape
    out = torch.empty((q, c), dtype=torch.int32, device=ts.device)
    if c == 0 or q == 0:
        return out
    tile = tile_for("masked_cumsum")
    n_tiles = cdiv(c, tile)
    block = tile // _ITEMS
    counts = torch.empty((q, n_tiles), dtype=torch.int32, device=ts.device)
    with torch.cuda.device(ts.device):
        stream = stream_ptr(ts)
        fn = _build.kernel_fn("masked_cumsum", "masked_cumsum_counts",
                              _COUNTS_ARGS)
        rc = fn(ts.data_ptr(), c, t_queries.data_ptr(), q, counts.data_ptr(),
                n_tiles, block, stream)
        _build.check(rc, "masked_cumsum", "masked_cumsum_counts")
        # exclusive per-tile offsets; cumsum of int32 promotes to int64
        # unless the dtype is given
        offsets = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
        fn = _build.kernel_fn("masked_cumsum", "masked_cumsum_scan",
                              _SCAN_ARGS)
        rc = fn(ts.data_ptr(), c, t_queries.data_ptr(), q,
                offsets.data_ptr(), n_tiles, out.data_ptr(), block, stream)
        _build.check(rc, "masked_cumsum", "masked_cumsum_scan")
    batched_masked_cumsum.launches += 1
    return out


batched_masked_cumsum.launches = 0


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
