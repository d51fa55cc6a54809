"""The ``compact()`` log rewrite: the horizon keep mask and the value move.

Compaction collapses every row's cell history at or below a horizon into
one base cell and splices the surviving tail back in (row, ts) order. The
keep mask over the cell timestamps is the CUDA kernel
``csrc/keep_mask.cu`` (wrapper :func:`keep_mask`, plain version
``ref.ref_keep_mask``); the value bytes move into the new order in one
``index_select`` on the store's device (the JAX package uses ``jnp.take``
there); the small int32 index work (lexsort, CSR pointers) stays in host
numpy, as in the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..obs import kerneltel
from . import _build, ref
from ._compat import bits_view, cdiv, check_tensor, from_bits, stream_ptr
from .launch import tile_for

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ITEMS = 4  # cells per thread, as in the kernel
_I32_LO, _TS_MAX = -(2**31) + 1, 2**31 - 2


def keep_mask(ts: torch.Tensor, cutoff: int):
    """ts: (C,) int32 -> (keep (C,) int32 = ts > cutoff, survivors per
    tile (ceil(C / tile_for("keep_mask")),) int32).

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the launch in ``keep_mask.launches``)."""
    check_tensor(ts, "ts", torch.int32, 1)
    cutoff = int(cutoff)
    if not -(2**31) <= cutoff < 2**31:
        raise ValueError(f"cutoff {cutoff} outside int32")
    tile = tile_for("keep_mask")
    if ts.device.type == "cpu":
        return ref.ref_keep_mask(ts, cutoff, tile)
    (c,) = ts.shape
    n_tiles = cdiv(c, tile)
    keep = torch.empty(c, dtype=torch.int32, device=ts.device)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=ts.device)
    if c == 0:
        return keep, counts
    fn = _build.kernel_fn("keep_mask", "keep_mask_launch", _ARGS)
    with torch.cuda.device(ts.device):
        rc = fn(ts.data_ptr(), c, cutoff, keep.data_ptr(), counts.data_ptr(),
                n_tiles, tile // _ITEMS, stream_ptr(ts))
    _build.check(rc, "keep_mask", "keep_mask_launch")
    keep_mask.launches += 1
    return keep, counts


keep_mask.launches = 0


def ref_compact_rewrite(vals, tss, ptr, base_vals, base_found, before_ts,
                        n_rows):
    """Host oracle: the plain numpy rewrite (the JAX package's own)."""
    keep = tss > before_ts
    rows_all = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(ptr))
    base_rows = np.nonzero(base_found)[0].astype(np.int32)
    new_rows = np.concatenate([base_rows, rows_all[keep]])
    new_tss = np.concatenate([
        np.full(len(base_rows), before_ts, np.int64), tss[keep]])
    new_vals = np.concatenate([base_vals[base_found], vals[keep]])
    order = np.lexsort((new_tss, new_rows))
    nptr = np.zeros(n_rows + 1, np.int32)
    np.add.at(nptr, new_rows + 1, 1)
    return (new_vals[order], new_tss[order], new_rows[order],
            np.cumsum(nptr).astype(np.int32))


def compact_rewrite(vals, tss, ptr, base_vals, base_found, before_ts,
                    n_rows, *, device):
    """Rewrite one cell log for a compaction at horizon ``before_ts``.

    Args:
      vals: (C, W) host cell values sorted by (row, ts).
      tss: (C,) int64 host cell timestamps (same order).
      ptr: (n_rows+1,) CSR row pointers.
      base_vals / base_found: ``select_at(n_rows, before_ts)`` output, the
        per-row folded base value at the horizon.
      before_ts: compaction horizon (inclusive).
      n_rows: row count.
      device: where the keep mask and the value gather run.

    Returns:
      (new_vals, new_tss int64, new_rows int32, new_ptr int32), host numpy,
      byte-identical to :func:`ref_compact_rewrite`.
    """
    c = len(tss)
    # traffic model: stream the (C,) ts for the mask (read + int32 mask
    # write) and move every value byte once on each side of the gather;
    # arithmetic: one compare per cell
    nb = 8 * c + 2 * (vals.nbytes + base_vals.nbytes)
    with kerneltel.launch("compact_rewrite", nbytes=nb, flops=c):
        # device timestamps are int32 (queries are clamped below TS_MAX),
        # so the mask compares in int32 against the clamped horizon
        cutoff = min(max(int(before_ts), _I32_LO), _TS_MAX)
        ts_dev = torch.as_tensor(tss.astype(np.int32), device=device)
        keep, _counts = keep_mask(ts_dev, cutoff)
        keep_idx = np.nonzero(keep.cpu().numpy())[0].astype(np.int32)
        rows_all = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(ptr))
        base_rows = np.nonzero(base_found)[0].astype(np.int32)
        new_rows = np.concatenate([base_rows, rows_all[keep_idx]])
        new_tss = np.concatenate([
            np.full(len(base_rows), before_ts, np.int64), tss[keep_idx]])
        order = np.lexsort((new_tss, new_rows))
        # the value bytes move in ONE device gather: output position ->
        # source row in concat(full base table, old cells)
        cat_pos = np.concatenate([base_rows, n_rows + keep_idx])
        src = torch.as_tensor(cat_pos[order].astype(np.int64), device=device)
        cat = torch.cat([torch.as_tensor(bits_view(base_vals), device=device),
                         torch.as_tensor(bits_view(vals), device=device)])
        new_vals = from_bits(cat.index_select(0, src), vals.dtype)
        nptr = np.zeros(n_rows + 1, np.int32)
        np.add.at(nptr, new_rows + 1, 1)
        return (new_vals, new_tss[order], new_rows[order],
                np.cumsum(nptr).astype(np.int32))
