"""VersionedStore: the GeStore meta-database data model (paper §III.B-§III.D).

The port of ``repro.core.store`` to PyTorch: the same data model, the same
answers, the same content digests, with the device work on a CUDA card
(or, when the caller passes ``device="cpu"``, on the host through the
kernels' plain torch versions).

HBase mapping -> columnar MVCC:
  * entries  -> rows (dense int index; byte-string keys via a host dict)
  * parsed fields -> fixed-width numeric columns (one ``_FieldColumn`` each;
    schema evolution = add a column, as in HBase)
  * timestamped cells -> an append-only per-field cell log, consolidated
    lazily to CSR (sorted by (row, ts)) for the ``version_select`` scan
  * EXISTS column -> a dedicated int8 cell log (tombstones on delete)

The four operations of §III.C: ``create`` (constructor), ``update``,
``get_increment``, ``get_version``. Change detection is fingerprint-based
(kernels/fingerprint.py) so an update touches O(changed) cells. Heavy scans
run on the store's device through the CUDA kernels; key bookkeeping, the
CSR build and the digest chain stay in host numpy (the HBase-master
analogue), exactly where the JAX package keeps them.

Persistence is segmented and append-only (core/segments.py), in the JAX
package's on-disk format byte for byte: ``save()`` writes only cells newer
than the on-disk manifest's watermark, ``load()`` attaches lazy segment
handles that are spliced into a log's CSR only when a query's timestamp
bound reaches them, and ``compact(..., path=...)`` rewrites covered
segments into a base segment while retaining the tail. ``core/state.py``
carries a store across in memory; ``core/shard.py`` spreads one over
shards.

Invalidation contract: ``log_epoch`` is a monotone counter bumped by every
log mutation (update/delete/add_field/compact). Any externally cached
materialization derived from this store MUST be keyed on
``(store name, log_epoch)`` — equal epoch for the same store object implies
bit-identical query results, so caches need no other invalidation hook.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import threading
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels._compat import bits_view, from_bits, resolve_device
from ..obs import kerneltel
from ..obs.trace import StageTimer

Timestamp = int

# device-side timestamps are int32; host keeps int64.
TS_MAX = 2**31 - 2

class OperationCancelled(RuntimeError):
    """A cooperatively cancelled query (see ``get_versions(cancel=...)``).

    The store is left untouched — cancellation points sit between read-only
    stages, never inside a mutation — so a cancelled query can simply be
    retried."""


def _check_cancel(cancel: Callable[[], bool] | None) -> None:
    """Cooperative cancellation point: queries accept an optional
    ``cancel`` callable and poll it between expensive stages (superlog
    build, batched scan, value gather), so a server can abandon a wave
    whose every request was cancelled before paying for device work."""
    if cancel is not None and cancel():
        raise OperationCancelled("query cancelled between stages")


def _checked_cast(name: str, vals, dtype: np.dtype) -> np.ndarray:
    """Cast a table value block to its field dtype, refusing same-kind
    narrowing that would silently corrupt: out-of-range ints and float
    magnitudes that overflow to inf / underflow to zero raise ValueError
    (float mantissa rounding is accepted — the engine is 32-bit)."""
    arr = np.asarray(vals)
    with np.errstate(over="ignore"):  # overflow is checked by value below
        out = np.ascontiguousarray(arr, dtype=dtype)
    if arr.dtype == out.dtype:
        return out
    if np.issubdtype(arr.dtype, np.integer) and np.issubdtype(dtype, np.integer):
        if not np.array_equal(out.astype(arr.dtype), arr):
            raise ValueError(
                f"field {name}: values exceed the {dtype} range")
    elif np.issubdtype(arr.dtype, np.floating) and \
            np.issubdtype(dtype, np.floating):
        bad = ((np.isfinite(arr) & ~np.isfinite(out))
               | ((arr != 0) & (out == 0)))
        if bad.any():
            raise ValueError(
                f"field {name}: magnitudes exceed the {dtype} range")
    return out


def _clamp_ts(t: Timestamp) -> int:
    return int(min(max(int(t), -(2**31) + 1), TS_MAX))


def infer_field_schema(name: str, values) -> "FieldSchema":
    """Schema for a field seen for the first time in an update table.

    np.asarray of plain Python numbers defaults to int64/float64 on 64-bit
    platforms; narrow to the engine's 32-bit lanes when lossless rather
    than tripping add_field's wide-dtype rejection. A sharded facade must
    call this on the FULL value block before scattering, so every shard
    adopts the same schema the unsharded store would have.
    """
    arr = np.asarray(values)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.dtype == np.int64:
        # bounds check, not abs (abs wraps for int64-min)
        if (arr.size == 0 or (arr.min() >= -(2**31)
                              and arr.max() <= 2**31 - 1)):
            arr = arr.astype(np.int32)
    elif arr.dtype == np.float64:
        with np.errstate(over="ignore"):  # overflow checked below
            a32 = arr.astype(np.float32)
        # mantissa rounding is accepted (the engine is 32-bit); magnitude
        # overflow to inf / underflow to zero is not — those fall through
        # to add_field's loud rejection
        bad = ((np.isfinite(arr) & ~np.isfinite(a32))
               | ((arr != 0) & (a32 == 0)))
        if not bad.any():
            arr = a32
    return FieldSchema(name, arr.shape[1], arr.dtype.name)


@dataclasses.dataclass(frozen=True)
class FieldSchema:
    name: str
    width: int
    dtype: str = "int32"  # numpy dtype name

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


@dataclasses.dataclass
class VersionInfo:
    """Row of the `updates` system table (§III.D)."""
    ts: Timestamp
    label: str
    n_entries: int
    n_new: int
    n_updated: int
    n_deleted: int


@dataclasses.dataclass
class VersionView:
    """A materialized meta-database version (get_version output)."""
    ts: Timestamp
    keys: list[bytes]
    row_idx: np.ndarray  # (K,) int32 store row index
    values: dict[str, np.ndarray]  # field -> (K, W)

    def __len__(self) -> int:
        return len(self.keys)


KIND_NEW, KIND_UPDATED, KIND_DELETED = 0, 1, 2


@dataclasses.dataclass
class Increment:
    """get_increment output: entries changed in (t0, t1]."""
    t0: Timestamp
    t1: Timestamp
    keys: list[bytes]
    row_idx: np.ndarray
    kind: np.ndarray  # (K,) int8 KIND_*
    values: dict[str, np.ndarray]  # values at t1 (zeros for deleted rows)

    def __len__(self) -> int:
        return len(self.keys)


class _CellLog:
    """Append-only timestamped cell log for one column, lazy CSR.

    Three cell sources feed the consolidated CSR: fresh appends
    (``_chunks``), a previously consolidated CSR (``_csr``), and — after a
    lazy load — on-disk segment handles (``_pending``, sorted by ts0).
    Pending segments are materialized only when a caller's timestamp bound
    reaches their range, so a pinned old version reads only the segments
    at or below that version. ``device`` is where the log's scans run.

    One lock guards the three sources: a release session's worker threads
    append while readers consolidate (``csr``), and a consolidation that
    cleared ``_chunks`` after an append it had not copied would drop that
    append's cells. (The JAX package's log has no lock and can drop them.)
    """

    def __init__(self, width: int, dtype: np.dtype, device: torch.device):
        self.width = width
        self.dtype = dtype
        self.device = device
        self._lock = threading.RLock()
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._csr: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None  # vals, ts, order-rows
        self._row_ptr: np.ndarray | None = None
        self._n_rows_at_build = -1
        self._pending: list = []  # unread segments.SegmentHandle, by ts0

    @property
    def n_cells(self) -> int:
        return (sum(len(c[1]) for c in self._chunks)
                + (0 if self._csr is None else len(self._csr[1]))
                + sum(h.n_cells for h in self._pending))

    def append(self, rows: np.ndarray, ts: Timestamp, vals: np.ndarray) -> None:
        if len(rows) == 0:
            return
        assert vals.shape == (len(rows), self.width)
        chunk = (rows.astype(np.int32), np.full(len(rows), ts, np.int64),
                 np.ascontiguousarray(vals, dtype=self.dtype))
        with self._lock:
            self._chunks.append(chunk)
            self._row_ptr = None  # CSR dirty

    # -- lazy on-disk segments ------------------------------------------------
    def attach_segments(self, handles) -> None:
        """Register on-disk segment handles (from a lazy load) without
        reading them."""
        if handles:
            with self._lock:
                self._pending = sorted(self._pending + list(handles),
                                       key=lambda h: h.ts0)

    def _materialize(self, handle) -> None:
        rows, tss, vals = handle.materialize()
        with self._lock:
            self._chunks.append((rows.astype(np.int32), tss.astype(np.int64),
                                 np.ascontiguousarray(vals, dtype=self.dtype)))
            self._row_ptr = None

    def _ensure(self, through_ts) -> None:
        """Splice every pending segment with ts0 <= through_ts into the log
        (cells strictly above the bound cannot affect a query at it)."""
        with self._lock:
            if not self._pending:
                return
            keep = []
            for h in self._pending:
                if h.ts0 <= through_ts:
                    self._materialize(h)
                else:
                    keep.append(h)
            self._pending = keep

    def splice_csr(self, vals: np.ndarray, tss: np.ndarray, rows: np.ndarray,
                   ptr: np.ndarray, n_rows: int) -> None:
        """Install a fully consolidated CSR directly (loader fast path)."""
        with self._lock:
            self._csr = (vals, tss, rows)
            self._chunks = []
            self._row_ptr = np.asarray(ptr)
            self._n_rows_at_build = n_rows

    def cells_after(self, cutoff: Timestamp):
        """All cells with ts > cutoff as (rows, ts, vals) sorted by
        (row, ts) — the incremental-save extraction. Only pending segments
        that could hold such cells (ts1 > cutoff) are read; for a store
        loaded from ``cutoff``'s own manifest that is none of them, so the
        cost is O(cells appended since the last save)."""
        with self._lock:
            keep = []
            for h in self._pending:
                if h.ts1 > cutoff:
                    self._materialize(h)
                else:
                    keep.append(h)
            self._pending = keep
            parts = list(self._chunks)
            if self._csr is not None:
                vals0, tss0, rows0 = self._csr
                parts.insert(0, (rows0, tss0, vals0))
            # mask per part BEFORE concatenating: a consolidated history with
            # nothing past the cutoff contributes one comparison pass, not a
            # full copy + lexsort — incremental save stays O(new cells)
            kept = []
            for rows, tss, vals in parts:
                m = tss > cutoff
                if m.any():
                    kept.append((rows[m], tss[m], vals[m]))
            if not kept:
                return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                        np.zeros((0, self.width), self.dtype))
            rows = np.concatenate([c[0] for c in kept])
            tss = np.concatenate([c[1] for c in kept])
            vals = np.concatenate([c[2] for c in kept])
            order = np.lexsort((tss, rows))
            return rows[order], tss[order], vals[order]

    def csr(self, n_rows: int, *, through_ts: Timestamp | None = None):
        """Returns (vals (C,W), ts (C,), row_ptr (n_rows+1,)) sorted by (row, ts).

        ``through_ts`` bounds which pending on-disk segments must be
        spliced in first: the returned CSR is complete for any query at
        t <= through_ts (None = materialize everything). Cells of rows at
        or past ``n_rows`` (a release session's new rows, appended since
        the caller read ``n_rows``) stay in the log, after the returned
        ones.
        """
        with self._lock:
            self._ensure(np.inf if through_ts is None else through_ts)
            if self._row_ptr is not None and self._n_rows_at_build == n_rows:
                c = self._row_ptr[-1]
                return self._csr[0][:c], self._csr[1][:c], self._row_ptr
            parts = list(self._chunks)  # each: (rows, ts, vals)
            if self._csr is not None:
                vals0, tss0, rows0 = self._csr
                parts.insert(0, (rows0, tss0, vals0))
            rows = (np.concatenate([c[0] for c in parts]) if parts
                    else np.zeros(0, np.int32))
            tss = (np.concatenate([c[1] for c in parts]) if parts
                   else np.zeros(0, np.int64))
            vals = (np.concatenate([c[2] for c in parts]) if parts
                    else np.zeros((0, self.width), self.dtype))
            order = np.lexsort((tss, rows))
            rows, tss, vals = rows[order], tss[order], vals[order]
            ptr = np.zeros(n_rows + 1, np.int32)
            np.add.at(ptr, np.minimum(rows + 1, n_rows), 1)
            ptr = np.cumsum(ptr).astype(np.int32)
            c = int(np.searchsorted(rows, n_rows))  # cells of rows < n_rows
            ptr[-1] = c
            self._csr = (vals, tss, rows)
            self._chunks = []
            self._row_ptr = ptr
            self._n_rows_at_build = n_rows
            return vals[:c], tss[:c], ptr

    def select_at(self, n_rows: int, t: Timestamp):
        """(vals_at_t (n_rows, W), found (n_rows,)) via the masked-cumsum
        kernel on the log's device. Only materializes on-disk segments at
        or below ``t``."""
        vals, tss, ptr = self.csr(n_rows, through_ts=t)
        if len(tss) == 0:
            return (np.zeros((n_rows, self.width), self.dtype),
                    np.zeros(n_rows, bool))
        dev = self.device
        out, found = kops.version_select(
            torch.as_tensor(bits_view(vals), device=dev),
            torch.as_tensor(tss.astype(np.int32), device=dev),
            torch.as_tensor(ptr, device=dev), _clamp_ts(t))
        return from_bits(out, self.dtype), found.cpu().numpy()

    def changed_counts(self, n_rows: int, t0: Timestamp, t1: Timestamp) -> np.ndarray:
        """Per-row number of cells with t0 < ts <= t1 (windowed scan, §III.C)."""
        _, tss, ptr = self.csr(n_rows, through_ts=t1)
        if len(tss) == 0:
            return np.zeros(n_rows, np.int32)
        dev = self.device
        # one batched launch serves both window ends
        c1, c0 = kops.batched_masked_cumsum(
            torch.as_tensor(tss.astype(np.int32), device=dev),
            torch.tensor([_clamp_ts(t1), _clamp_ts(t0)], dtype=torch.int32,
                         device=dev)).cpu().numpy()
        cum = np.concatenate([[0], c1 - c0])
        return (cum[ptr[1:]] - cum[ptr[:-1]]).astype(np.int32)


@dataclasses.dataclass
class _SuperLogField:
    """One log's slice of the fused superlog.

    When ``packed_host`` is set the field stays *delta-packed on device*:
    cells are stored as narrowed chain deltas (first cell of every row
    chain raw, flagged by ``heads_host``) and the gather path decodes them
    on the device (kernels/delta_codec.chain_decode_at), so device bytes and
    upload traffic shrink by the narrowing factor. ``vals_host`` remains
    the decoded host copy. Device copies hold the values' bits as the
    signed int of their width (``bits_view``), so every stored dtype
    gathers bit-exactly."""
    offset: int                 # first cell of this log in the fused ts array
    b_off: int                  # first entry of this log in the fused boundary array
    n_cells: int
    width: int
    dtype: np.dtype
    ptr: np.ndarray             # (N+1,) log-local CSR offsets (host)
    vals_host: np.ndarray | None  # (C_f, W) consolidated cell values
    device: torch.device        # upload target
    packed_host: np.ndarray | None = None  # narrowed chain deltas
    heads_host: np.ndarray | None = None   # (C_f,) chain-head flags
    _vals_dev: torch.Tensor | None = None
    _packed_dev: torch.Tensor | None = None
    _heads_dev: torch.Tensor | None = None

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def vals_dev(self) -> torch.Tensor | None:
        """Device copy of the cell values' bits, uploaded on first gather —
        a narrow-field query must not pay for the store's wide columns."""
        if self._vals_dev is None and self.vals_host is not None:
            self._vals_dev = self._put(bits_view(self.vals_host))
        return self._vals_dev

    def take_cells(self, idx: np.ndarray) -> torch.Tensor:
        """ONE device gather of cell values' bits at field-local cell
        indices. Delta-packed fields decode only the taken cells, each
        from its chain's head (``kops.chain_decode_at``); the device keeps
        only the packed copy."""
        idx = torch.as_tensor(idx, device=self.device)
        if self.packed_host is None:
            return self.vals_dev().index_select(0, idx)
        if self._packed_dev is None:
            self._packed_dev = self._put(self.packed_host)
            self._heads_dev = self._put(self.heads_host)
        # the int32 scan of each taken cell's chain truncated to the stored
        # width == the host depth loop; the signed int of that width
        # carries the stored bits
        return kops.chain_decode_at(self._packed_dev, self._heads_dev, idx,
                                    itemsize=self.dtype.itemsize)

    def dev_nbytes(self) -> int:
        n = 0
        for a in (self._vals_dev, self._packed_dev, self._heads_dev):
            if a is not None:
                n += a.numel() * a.element_size()
        return n


def _pack_field(vals: np.ndarray, ptr: np.ndarray):
    """Chain-delta pack one field's consolidated cells for device residency.

    Same chain format as the on-disk segments (kernels/delta_codec): first
    cell of every row chain raw, later cells as wraparound deltas vs their
    predecessor, narrowed when the whole run fits a smaller int. Returns
    (packed, heads) when narrowing actually shrinks device bytes, else
    (None, None) — floats, int8, and incompressible runs stay unpacked.
    Disable globally with ``GESTORE_PACKED_SUPERLOG=0``."""
    dt = vals.dtype
    if not np.issubdtype(dt, np.integer) or not 2 <= dt.itemsize <= 4:
        return None, None
    heads = np.zeros(len(vals), bool)
    heads[ptr[:-1][np.diff(ptr) > 0]] = True
    prev = np.roll(vals, 1, axis=0)
    prev[heads] = 0  # chain heads pack against zero (stored raw)
    with np.errstate(over="ignore"):
        delta = vals - prev
    # min/max as Python ints: exact even at the int32 minimum
    maxabs = (max(-int(delta.min()), int(delta.max())) if delta.size else 0)
    narrow = np.dtype(kops.narrow_dtype(maxabs, base=dt))
    if narrow.itemsize >= dt.itemsize:
        return None, None
    # heads ride along as one byte/cell; only pack when that still wins
    if narrow.itemsize * vals.shape[1] + 1 >= dt.itemsize * vals.shape[1]:
        return None, None
    return delta.astype(narrow), heads


class _SuperLog:
    """Consolidated device-resident CSR over every cell log of a store.

    All field logs plus the EXISTS log are fused into ONE device timestamp
    array with per-field cell offsets, so materializing Q versions costs a
    single batched masked-cumsum launch over the fused array
    (kernels/batched_select.py) instead of Q*F per-field launches that each
    re-upload their log from host. Per-field boundary gathers and value
    gathers are O(boundaries) / O(selected) afterthoughts.

    A snapshot is immutable; ``VersionedStore`` rebuilds it lazily whenever
    the log epoch moves (any append/compact/load).
    """

    EXISTS = "__exists__"

    def __init__(self, store: "VersionedStore"):
        self.n_rows = store.n_rows
        self.epoch = store.log_epoch
        self.device = store.device
        logs: dict[str, _CellLog] = {n: c.log for n, c in store.fields.items()}
        logs[self.EXISTS] = store.exists_log
        ts_parts: list[np.ndarray] = []
        bnd_parts: list[np.ndarray] = []
        self.fields: dict[str, _SuperLogField] = {}
        pack_ok = os.environ.get("GESTORE_PACKED_SUPERLOG", "1") != "0"
        off = b_off = 0
        for name, log in logs.items():
            vals, tss, ptr = log.csr(self.n_rows)
            ptr = np.asarray(ptr)
            f = _SuperLogField(
                offset=off, b_off=b_off, n_cells=len(tss), width=log.width,
                dtype=log.dtype, ptr=ptr,
                vals_host=vals if len(tss) else None, device=self.device)
            if pack_ok and f.vals_host is not None and name != self.EXISTS:
                f.packed_host, f.heads_host = _pack_field(vals, ptr)
            self.fields[name] = f
            ts_parts.append(tss.astype(np.int32))
            bnd_parts.append(off + ptr.astype(np.int64))
            off += len(tss)
            b_off += len(ptr)
        self.n_cells = off
        # fused ts stays host-side until the first scan needs it
        self.ts_host = np.concatenate(ts_parts) if off else None
        self._ts_dev = None
        # every field's CSR boundaries in fused-cell coordinates: the scan
        # result is only ever read at these positions
        self.boundaries = np.concatenate(bnd_parts)

    @property
    def ts(self) -> torch.Tensor | None:
        """Device copy of the fused ts array, uploaded on first use, in a
        buffer padded to a power-of-two cell bucket with int32 max (above
        every clamped query), the same device bytes as the JAX package's
        copy. The scan reads only the ``n_cells`` real cells."""
        if self._ts_dev is None and self.ts_host is not None:
            c = len(self.ts_host)
            c_pad = kops.scan_bucket(c)
            padded = self.ts_host
            if c_pad != c:
                padded = np.concatenate([
                    padded,
                    np.full(c_pad - c, np.iinfo(np.int32).max, np.int32)])
            self._ts_dev = torch.as_tensor(padded, device=self.device)
        return self._ts_dev

    # -- the one batched scan -------------------------------------------------
    def boundary_cums(self, ts_list: Sequence[Timestamp]) -> np.ndarray:
        """(Q, n_boundaries) cumsum of (ts <= t_q) AT every field's CSR
        boundaries: ONE batched kernel launch for all queries and all
        fields, with only the boundary columns crossing device->host
        (O(Q x F x N), not O(Q x total_cells))."""
        qs = np.asarray([_clamp_ts(t) for t in ts_list], np.int32)
        out = np.zeros((len(qs), len(self.boundaries)), np.int32)
        if self.n_cells and len(qs):
            q, c, b = len(qs), self.n_cells, len(self.boundaries)
            bnd = self.boundaries
            # traffic model: read the fused ts once (C*4), write the
            # (Q, C) running cumsum, read+write the (Q, B) boundary
            # columns; arithmetic: one compare + one add per (q, cell)
            with kerneltel.launch("batched_select",
                                  nbytes=4 * (c + q * c + 2 * q * b),
                                  flops=2 * q * c):
                cum = kops.batched_masked_cumsum(
                    self.ts[:c], torch.as_tensor(qs, device=self.device))
                at = cum.index_select(1, torch.as_tensor(
                    np.maximum(bnd - 1, 0), device=self.device))
                at[:, torch.as_tensor(bnd == 0, device=self.device)] = 0
                out = at.cpu().numpy()
        return out

    # -- per-field boundary math ----------------------------------------------
    def counts(self, name: str, bcum: np.ndarray) -> np.ndarray:
        """(Q, N) per-row count of cells with ts <= t_q for one field."""
        f = self.fields[name]
        b = bcum[:, f.b_off: f.b_off + len(f.ptr)]
        return b[:, 1:] - b[:, :-1]

    def exists_matrix(self, bcum: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(alive (Q, N), ever (Q, N)) from the EXISTS log."""
        f = self.fields[self.EXISTS]
        cnt = self.counts(self.EXISTS, bcum)
        ever = cnt > 0
        if f.vals_host is None:
            return np.zeros_like(ever), ever
        idx = np.clip(f.ptr[None, :-1] + cnt - 1, 0, f.n_cells - 1)
        v = f.vals_dev()[:, 0][torch.as_tensor(idx, device=self.device)]
        return (v.cpu().numpy() > 0) & ever, ever

    def gather_dispatch(self, name: str, cnts: "Sequence[np.ndarray]",
                        sels: Sequence[np.ndarray]) -> tuple:
        """Launch the fused per-field gather WITHOUT forcing a host sync:
        returns an opaque handle for ``gather_finalize``, so a caller
        holding several stores can dispatch every gather before
        collecting any."""
        f = self.fields[name]
        lens = [len(s) for s in sels]
        if f.vals_host is None or sum(lens) == 0:
            return (None, lens, None)
        cat_cnt = np.concatenate([c[s] for c, s in zip(cnts, sels)])
        cat_rows = np.concatenate(sels)
        idx = np.clip(f.ptr[cat_rows] + cat_cnt - 1, 0, f.n_cells - 1)
        dev = f.take_cells(idx)  # decodes delta-packed fields on device
        return (dev, lens, cat_cnt)

    def gather_finalize(self, name: str, handle: tuple) -> list[np.ndarray]:
        """Collect a ``gather_dispatch`` result to host, split per query.
        Rows with no cell at the query time come back zeroed (same
        semantics as _CellLog.select_at)."""
        dev, lens, cat_cnt = handle
        f = self.fields[name]
        if dev is None:
            return [np.zeros((l, f.width), f.dtype) for l in lens]
        out = from_bits(dev, f.dtype)
        out[cat_cnt <= 0] = 0
        offs = np.cumsum([0] + lens)
        return [out[offs[i]: offs[i + 1]] for i in range(len(lens))]

    def gather_many(self, name: str, cnts: "Sequence[np.ndarray]",
                    sels: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Per-query row selections fused into ONE device gather per field:
        cnts[q] the (N,) per-row counts and sels[q] the selected rows of
        query q (dispatch + finalize in one step)."""
        return self.gather_finalize(name, self.gather_dispatch(name, cnts,
                                                               sels))


class _FieldColumn:
    """Head state + cell log for one field.

    ``head_stale`` marks heads not yet rebuilt after a lazy load; the store
    rebuilds them (one select_at(TS_MAX)) before the first mutation that
    needs change detection, so opening a store stays O(manifest)."""

    def __init__(self, schema: FieldSchema, capacity: int,
                 device: torch.device):
        self.schema = schema
        self.log = _CellLog(schema.width, schema.np_dtype, device)
        self.head_vals = np.zeros((capacity, schema.width), schema.np_dtype)
        self.head_fp = np.zeros((capacity, 2), np.int32)
        self.head_has = np.zeros(capacity, bool)
        self.head_stale = False

    def grow(self, capacity: int) -> None:
        def g(a):
            out = np.zeros((capacity,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out
        self.head_vals = g(self.head_vals)
        self.head_fp = g(self.head_fp)
        self.head_has = g(self.head_has)


class ReleaseSession:
    """Chunked single-release mutation (the streaming-ingest write path).

    ``store.begin_release(ts)`` -> repeated ``apply(keys, table)`` (one
    bounded-memory chunk each) -> ``finish()``. The committed result is
    equivalent to one whole-file ``update(ts, all_keys, all_table)`` over
    the concatenated chunks — identical cells, heads, counts, VersionInfo
    AND content digest — provided keys are unique within the release
    (true of real database releases; a duplicate key repeating identical
    values would be fingerprint-skipped here but double-appended by the
    whole-file path).

    Each ``apply`` validates everything before mutating anything, exactly
    like ``update`` — but the release only commits at ``finish()``: the
    tombstone scan (full releases), the VersionInfo record and the
    digest-chain link all happen there. A session abandoned mid-way
    leaves cells at ``ts`` in the logs with NO version record — in-memory
    state that must be discarded (the ingest journal's resume protocol
    reloads the pre-release store from disk and replays chunks).

    ``present_keys`` patch semantics are not supported — use ``update``.
    """

    def __init__(self, store: "VersionedStore", ts: Timestamp, *,
                 label: str = "", full_release: bool = True):
        if ts <= store.last_ts:
            raise ValueError(
                f"timestamps must be monotonic: {ts} <= {store.last_ts}")
        store._ensure_exists_head()
        self.store = store
        self.ts = int(ts)
        self.label = label
        self.full_release = full_release
        self.n_entries = 0
        self._n_new = 0
        self._n_upd = 0
        self._rows_parts: list[np.ndarray] = []    # rows touched, per chunk
        # digest-chain payload accumulators, assembled at finish() into the
        # exact byte layout update() hashes: per-field blocks in first-seen
        # table order, then appearing rows, then tombstoned rows
        self._field_order: list[str] = []
        self._field_rows: dict[str, list[bytes]] = {}
        self._field_fps: dict[str, list[bytes]] = {}
        self._appear_parts: list[bytes] = []
        self._finished = False

    def apply(self, keys: Sequence[bytes],
              table: Mapping[str, np.ndarray], *,
              _precast: bool = False, _fps=None) -> int:
        """Ingest one chunk of the release; returns the chunk entry count.

        Validation order mirrors ``update``: key encode, schema inference
        for unseen fields, value-checked casts and shape asserts all run
        before the first cell append, so a rejected chunk leaves no
        phantom columns, rows or cells. NOTE: schema inference for a new
        field sees only this chunk's value block — pre-declare fields via
        ``add_field`` (the ingest engine passes the parser schema) when a
        later chunk might need a wider dtype.

        ``_precast``/``_fps`` are a sharded facade's wave fast path
        (``core/shard.ShardedReleaseSession``): the facade value-casts the
        full chunk and fingerprints it with ONE kernel launch per field, so
        per-shard sub-applies skip the cast and slice the shared
        fingerprints instead of launching ``n_shards`` small fingerprint
        kernels."""
        if self._finished:
            raise RuntimeError("release session already finished")
        st = self.store
        keys = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
        new_fields: dict[str, FieldSchema] = {}
        if not _precast:
            for name in table:
                if name not in st.fields:
                    fs = infer_field_schema(name, table[name])
                    st._validate_new_field(fs)
                    new_fields[name] = fs
        casted: dict[str, np.ndarray] = {}
        for name, vals in table.items():
            if _precast:
                casted[name] = vals
            else:
                fs = new_fields.get(name) or st.fields[name].schema
                vals = _checked_cast(name, vals, fs.np_dtype)
                if vals.ndim == 1:
                    vals = vals[:, None]
                assert vals.shape == (len(keys), fs.width), (
                    f"{name}: {vals.shape} != {(len(keys), fs.width)}")
                casted[name] = vals
            if name not in self._field_rows:
                self._field_order.append(name)
                self._field_rows[name] = []
                self._field_fps[name] = []
        for fs in new_fields.values():
            st.add_field(fs)
        was_known = np.fromiter((k in st.key_to_row for k in keys), bool,
                                count=len(keys))
        rows = st._rows_for_keys(keys, create=True)
        existed = np.zeros(len(keys), bool)
        existed[was_known] = st._exists_head[rows[was_known]]
        is_new = ~existed
        chunk_updated = np.zeros(st.n_rows, bool)
        for name, vals in casted.items():
            col = st.fields[name]
            st._ensure_head(name)
            fp = (_fps[name] if _fps is not None
                  else kops.fingerprint_rows(vals, st.device))
            same = (fp == col.head_fp[rows]).all(axis=1) & col.head_has[rows]
            changed = ~same
            if changed.any():
                cr = rows[changed]
                col.log.append(cr, self.ts, vals[changed])
                col.head_vals[cr] = vals[changed]
                col.head_fp[cr] = fp[changed]
                col.head_has[cr] = True
                chunk_updated[cr] |= True
                self._field_rows[name].append(cr.tobytes())
                self._field_fps[name].append(
                    np.ascontiguousarray(fp[changed]).tobytes())
        appearing = rows[is_new]
        if len(appearing):
            st.exists_log.append(appearing, self.ts,
                                 np.ones((len(appearing), 1), np.int8))
            st._exists_head[appearing] = True
            self._appear_parts.append(appearing.tobytes())
        self.n_entries += len(keys)
        self._n_new += int(is_new.sum())
        self._n_upd += int((chunk_updated[rows] & existed).sum())
        self._rows_parts.append(rows)
        st._invalidate_log()  # mid-session queries must not reuse caches
        return len(keys)

    def finish(self) -> VersionInfo:
        """Commit the release: tombstone scan (full releases), version
        record, digest-chain link. Idempotence is the caller's job —
        calling twice raises."""
        if self._finished:
            raise RuntimeError("release session already finished")
        self._finished = True
        st = self.store
        hparts = [str(self.ts).encode(), str(self.n_entries).encode()]
        for name in self._field_order:
            if self._field_rows[name]:
                hparts += [name.encode(), b"".join(self._field_rows[name]),
                           b"".join(self._field_fps[name])]
        if self._appear_parts:
            hparts.append(b"".join(self._appear_parts))
        n_deleted = 0
        if self.full_release:
            mask = np.zeros(st.n_rows, bool)
            for rows in self._rows_parts:
                mask[rows] = True
            gone = np.nonzero(st._exists_head[: st.n_rows] & ~mask)[0]
            if len(gone):
                st.exists_log.append(gone.astype(np.int32), self.ts,
                                     np.zeros((len(gone), 1), np.int8))
                st._exists_head[gone] = False
                n_deleted = len(gone)
                hparts.append(gone.tobytes())
        info = VersionInfo(ts=self.ts, label=self.label or str(self.ts),
                           n_entries=self.n_entries, n_new=self._n_new,
                           n_updated=self._n_upd, n_deleted=n_deleted)
        st.versions.append(info)
        st._chain_digest(b"".join(hparts))
        st._invalidate_log()
        return info


class VersionedStore:
    """One meta-database (one HBase table in the paper).

    Public surface: ``update``/``delete`` ingest releases, ``get_version``/
    ``get_versions`` and ``get_increment``/``get_increments`` materialize,
    ``compact`` collapses old history (in memory, and on disk with
    ``path=``), ``save``/``load`` persist to the segmented on-disk layout
    (core/segments.py), ``to_state``/``from_state`` carry a store across in
    memory (core/state.py), and ``log_epoch`` is the cache-invalidation
    contract (see module docstring).

    ``device``: where the store's scans, gathers and fingerprints run.
    None means the CUDA card, and raises without one; pass ``"cpu"`` to
    run the kernels' plain torch versions on the host. Query results are
    the same bytes on either.
    """

    def __init__(self, name: str, schema: Sequence[FieldSchema],
                 capacity: int = 1024, *, device=None):
        self.device = resolve_device(device)
        self.name = name
        self.schema: dict[str, FieldSchema] = {}
        self.fields: dict[str, _FieldColumn] = {}
        self.capacity = max(capacity, 16)
        self.n_rows = 0
        self.key_to_row: dict[bytes, int] = {}
        self.row_keys: list[bytes] = []
        self.exists_log = _CellLog(1, np.dtype(np.int8), self.device)
        self._exists_head = np.zeros(self.capacity, bool)
        self._exists_head_stale = False
        self.versions: list[VersionInfo] = []
        # chained per-release content digests (aligned with `versions`):
        # the incremental-save compatibility check compares these as a
        # prefix, so a same-shaped but different-content history can never
        # be mistaken for "the same store, further along"
        self._version_digests: list[str] = []
        self._history_digest = ""
        self._log_epoch = 0
        self._superlog: _SuperLog | None = None
        for fs in schema:
            self.add_field(fs)

    def _chain_digest(self, payload: bytes) -> None:
        d = hashlib.sha256((self._history_digest + "|").encode()
                           + payload).hexdigest()[:16]
        self._history_digest = d
        self._version_digests.append(d)

    def _rechain_digests(self, seed: str) -> None:
        """Rebuild the digest chain deterministically from the current
        versions list (compaction replaces the history prefix; the seed
        carries the pre-compaction content digest forward)."""
        d = seed
        out = []
        for v in self.versions:
            d = hashlib.sha256(
                f"{d}|{dataclasses.asdict(v)}".encode()).hexdigest()[:16]
            out.append(d)
        self._version_digests = out
        self._history_digest = out[-1] if out else seed

    # -- fused superlog lifecycle -------------------------------------------
    @property
    def log_epoch(self) -> int:
        """Monotone counter bumped on every log mutation; (store, log_epoch)
        keys any externally cached materialization plan."""
        return self._log_epoch

    def _invalidate_log(self) -> None:
        self._log_epoch += 1
        self._superlog = None

    def superlog(self) -> _SuperLog:
        """Device-resident consolidated CSR, rebuilt lazily on append."""
        if not self._superlog_fresh():
            self._superlog = _SuperLog(self)
        return self._superlog

    def _superlog_fresh(self) -> bool:
        sl = self._superlog
        return (sl is not None and sl.epoch == self._log_epoch
                and sl.n_rows == self.n_rows)

    def drop_superlog(self) -> None:
        """Release the device-resident fused superlog (device -> host
        demotion, used by the tiered memory manager). Query results are
        unaffected: the next batched query rebuilds it from the host CSR."""
        self._superlog = None

    def has_device_state(self) -> bool:
        """Whether a fused superlog (the device tier) is currently held —
        the tiered memory manager's device->host demotion predicate,
        shared with ShardedStore."""
        return self._superlog is not None

    def nbytes(self) -> dict:
        """Resident-memory accounting: ``{"host": int, "device": int}``.

        host = consolidated CSRs + unconsolidated chunks + head arrays
        (cells still pending on disk count zero — that is the point of the
        lazy load); device = the fused superlog's uploaded buffers."""
        host = self._exists_head.nbytes
        for col in self.fields.values():
            host += col.head_vals.nbytes + col.head_fp.nbytes + col.head_has.nbytes
        for log in [c.log for c in self.fields.values()] + [self.exists_log]:
            if log._csr is not None:
                vals, tss, rows = log._csr
                host += vals.nbytes + tss.nbytes + rows.nbytes
            if log._row_ptr is not None:
                host += log._row_ptr.nbytes
            for rows, tss, vals in log._chunks:
                host += vals.nbytes + tss.nbytes + rows.nbytes
        device = 0
        sl = self._superlog
        if sl is not None:
            if sl._ts_dev is not None:  # lazy: reading .ts would upload
                device += sl._ts_dev.numel() * sl._ts_dev.element_size()
            for f in sl.fields.values():
                device += f.dev_nbytes()
        return {"host": host, "device": device}

    # -- head (latest-value) state, rebuilt lazily after load ----------------
    def mark_heads_stale(self) -> None:
        """Defer head rebuilds (loader hook): heads are reconstructed from
        the logs on the first mutation that needs change detection."""
        for col in self.fields.values():
            col.head_stale = True
        self._exists_head_stale = True

    def rebuild_heads(self, fields: Sequence[str] | None = None) -> None:
        """Force stale heads fresh now.

        Queries never need this (they read the logs), but code that reads
        ``head_vals``/``head_fp``/``head_has`` directly MUST call it after
        a lazy ``load()`` — heads are only rebuilt automatically on the
        first mutation. ``fields=None`` rebuilds everything including the
        EXISTS head; a field list rebuilds just those columns."""
        for name in (fields if fields is not None else list(self.fields)):
            self._ensure_head(name)
        if fields is None:
            self._ensure_exists_head()

    def _ensure_head(self, name: str) -> None:
        col = self.fields[name]
        if not col.head_stale:
            return
        hv, found = col.log.select_at(self.n_rows, TS_MAX)
        col.head_vals[: self.n_rows] = hv
        col.head_has[: self.n_rows] = found
        if found.any():
            col.head_fp[np.nonzero(found)[0]] = kops.fingerprint_rows(
                hv[found], self.device)
        col.head_stale = False

    def _ensure_exists_head(self) -> None:
        if not self._exists_head_stale:
            return
        self._exists_head[: self.n_rows] = self.exists_at(TS_MAX)
        self._exists_head_stale = False

    # -- schema evolution (HBase column flexibility, §III.B) ----------------
    def _validate_new_field(self, fs: FieldSchema) -> None:
        """All add_field preconditions, with no mutation — callers that
        register several fields (or validate a whole release up front)
        check everything before changing anything."""
        if fs.name in self.fields:
            raise ValueError(f"field {fs.name} exists")
        if fs.name == "__exists__":
            # reserved: the superlog and the on-disk segments store the
            # tombstone log under this sentinel
            raise ValueError("field name __exists__ is reserved")
        if fs.np_dtype.itemsize > 4:
            # the query engine runs 32-bit lanes (the JAX package, with
            # 64-bit types off, would silently downcast int64/float64 cells;
            # the port refuses the same fields so both hold the same data).
            # Wide values belong in multiple 32-bit lanes.
            raise ValueError(
                f"field {fs.name}: dtype {fs.dtype} is wider than 32 bits, "
                "which the query engine cannot materialize losslessly")

    def add_field(self, fs: FieldSchema) -> None:
        """Add a column (schema evolution). Existing rows read as zeros /
        not-found until a release writes them. Raises ValueError when the
        field already exists."""
        self._validate_new_field(fs)
        self.schema[fs.name] = fs
        self.fields[fs.name] = _FieldColumn(fs, self.capacity, self.device)
        self._invalidate_log()

    # -- row allocation ------------------------------------------------------
    def _rows_for_keys(self, keys: Sequence[bytes], create: bool) -> np.ndarray:
        out = np.empty(len(keys), np.int32)
        for i, k in enumerate(keys):
            row = self.key_to_row.get(k, -1)
            if row < 0:
                if not create:
                    raise KeyError(k)
                row = self.n_rows
                self.n_rows += 1
                self.key_to_row[k] = row
                self.row_keys.append(k)
                if self.n_rows > self.capacity:
                    self.capacity *= 2
                    for col in self.fields.values():
                        col.grow(self.capacity)
                    e = np.zeros(self.capacity, bool)
                    e[: len(self._exists_head)] = self._exists_head
                    self._exists_head = e
            out[i] = row
        return out

    @property
    def last_ts(self) -> Timestamp:
        return self.versions[-1].ts if self.versions else -1

    # -- update (§III.C "update") -------------------------------------------
    def update(self, ts: Timestamp, keys: Sequence[bytes],
               table: Mapping[str, np.ndarray], *, label: str = "",
               full_release: bool = True,
               present_keys: Sequence[bytes] | None = None) -> VersionInfo:
        """Ingest a release. ``table``: field -> (M, W) rows aligned with keys.

        full_release=True: keys absent from this release are tombstoned
        (the paper compares consecutive full UniProtKB releases).
        full_release=False: patch semantics, absent keys untouched — unless
        ``present_keys`` lists the full release key set (then rows outside
        it are tombstoned even though only changed rows carry data).

        Args:
          ts: release timestamp, strictly greater than ``last_ts`` (the
            append-only logs and the incremental-save watermark both rely
            on monotonicity).
          keys: entry keys (str or bytes), aligned with ``table`` rows.
          table: field name -> (len(keys), width) values; unknown fields
            trigger schema evolution (a new column is added on the fly).
          label: human-readable release label for the `updates` table.

        Returns:
          VersionInfo with new/updated/deleted counts.

        Raises:
          ValueError: non-monotonic ``ts``.
          AssertionError: a table value block has the wrong shape.
        """
        if ts <= self.last_ts:
            raise ValueError(f"timestamps must be monotonic: {ts} <= {self.last_ts}")
        self._ensure_exists_head()
        # validate EVERYTHING before any mutation — schema registration,
        # row allocation, cell appends: a release rejected on its third
        # field (or an unconvertible key) must leave no phantom columns,
        # rows, or cells behind
        keys = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
        new_fields: dict[str, FieldSchema] = {}
        for name in table:
            if name not in self.fields:
                # schema evolution on the fly (see infer_field_schema)
                fs = infer_field_schema(name, table[name])
                self._validate_new_field(fs)
                new_fields[name] = fs
        casted: dict[str, np.ndarray] = {}
        for name, vals in table.items():
            fs = new_fields.get(name) or self.fields[name].schema
            vals = _checked_cast(name, vals, fs.np_dtype)
            if vals.ndim == 1:
                vals = vals[:, None]
            assert vals.shape == (len(keys), fs.width), (
                f"{name}: {vals.shape} != {(len(keys), fs.width)}")
            casted[name] = vals
        for fs in new_fields.values():
            self.add_field(fs)
        was_known = np.fromiter((k in self.key_to_row for k in keys), bool,
                                count=len(keys))
        rows = self._rows_for_keys(keys, create=True)
        existed = np.zeros(len(keys), bool)
        existed[was_known] = self._exists_head[rows[was_known]]
        is_new = ~existed

        n_updated_rows = np.zeros(self.n_rows, bool)
        hparts = [str(ts).encode(), str(len(keys)).encode()]
        for name, vals in casted.items():
            col = self.fields[name]
            self._ensure_head(name)
            fp = kops.fingerprint_rows(vals, self.device)
            same = (fp == col.head_fp[rows]).all(axis=1) & col.head_has[rows]
            changed = ~same
            if changed.any():
                cr = rows[changed]
                col.log.append(cr, ts, vals[changed])
                col.head_vals[cr] = vals[changed]
                col.head_fp[cr] = fp[changed]
                col.head_has[cr] = True
                n_updated_rows[cr] |= True
                hparts += [name.encode(), cr.tobytes(),
                           np.ascontiguousarray(fp[changed]).tobytes()]

        # EXISTS transitions
        appearing = rows[is_new]
        if len(appearing):
            self.exists_log.append(appearing, ts, np.ones((len(appearing), 1), np.int8))
            self._exists_head[appearing] = True
            hparts.append(appearing.tobytes())
        n_deleted = 0
        if full_release or present_keys is not None:
            mask = np.zeros(self.n_rows, bool)
            mask[rows] = True
            if present_keys is not None:
                for k in present_keys:
                    k = k.encode() if isinstance(k, str) else bytes(k)
                    r = self.key_to_row.get(k, -1)
                    if r >= 0:
                        mask[r] = True
            gone = np.nonzero(self._exists_head[: self.n_rows] & ~mask)[0]
            if len(gone):
                self.exists_log.append(gone.astype(np.int32), ts,
                                       np.zeros((len(gone), 1), np.int8))
                self._exists_head[gone] = False
                n_deleted = len(gone)
                hparts.append(gone.tobytes())

        n_new = int(is_new.sum())
        n_upd = int((n_updated_rows[rows] & existed).sum())
        info = VersionInfo(ts=ts, label=label or str(ts), n_entries=len(keys),
                           n_new=n_new, n_updated=n_upd, n_deleted=n_deleted)
        self.versions.append(info)
        self._chain_digest(b"".join(hparts))
        self._invalidate_log()
        return info

    def begin_release(self, ts: Timestamp, *, label: str = "",
                      full_release: bool = True) -> ReleaseSession:
        """Open a chunked mutation session for ONE release at ``ts`` —
        the streaming twin of ``update`` (see ``ReleaseSession``)."""
        return ReleaseSession(self, ts, label=label,
                              full_release=full_release)

    def delete(self, ts: Timestamp, keys: Sequence[bytes], *, label: str = "") -> VersionInfo:
        """Tombstone ``keys`` at ``ts`` (history below ``ts`` is preserved).

        Args:
          ts: deletion timestamp, strictly greater than ``last_ts``.
          keys: existing entry keys (str or bytes).
          label: release label; defaults to ``delete@<ts>``.

        Returns:
          VersionInfo whose ``n_deleted`` is ``len(keys)``.

        Raises:
          ValueError: non-monotonic ``ts``.
          KeyError: a key was never ingested.
        """
        if ts <= self.last_ts:
            raise ValueError(f"timestamps must be monotonic: {ts} <= {self.last_ts}")
        self._ensure_exists_head()
        keys = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
        rows = self._rows_for_keys(keys, create=False)
        self.exists_log.append(rows, ts, np.zeros((len(rows), 1), np.int8))
        self._exists_head[rows] = False
        info = VersionInfo(ts, label or f"delete@{ts}", len(keys), 0, 0, len(keys))
        self.versions.append(info)
        self._chain_digest(b"delete|" + str(ts).encode() + rows.tobytes())
        self._invalidate_log()
        return info

    # -- exists at a point in time -------------------------------------------
    def exists_at(self, t: Timestamp) -> np.ndarray:
        """(n_rows,) bool — which rows are alive (not tombstoned) at ``t``."""
        vals, found = self.exists_log.select_at(self.n_rows, t)
        return (vals[:, 0] > 0) & found

    def _filter_sel(self, sel: np.ndarray,
                    key_filter: str | Callable[[bytes], bool] | None) -> np.ndarray:
        if key_filter is None or len(sel) == 0:
            return sel
        if isinstance(key_filter, (str, bytes)):
            pat = re.compile(key_filter.encode()
                             if isinstance(key_filter, str) else key_filter)
            fmask = np.fromiter((pat.search(self.row_keys[r]) is not None
                                 for r in sel), bool, count=len(sel))
        else:
            fmask = np.fromiter((key_filter(self.row_keys[r]) for r in sel),
                                bool, count=len(sel))
        return sel[fmask]

    # -- get_version / get_versions (§III.C) ----------------------------------
    def get_versions(self, ts_list: Sequence[Timestamp], *,
                     fields: Sequence[str] | None = None,
                     key_filter: str | Callable[[bytes], bool] | None = None,
                     include_deleted: bool = False,
                     cancel: Callable[[], bool] | None = None,
                     trace: dict | None = None) -> list[VersionView]:
        """Materialize MANY versions in one batched scan of the fused
        superlog (not len(ts_list) x n_fields kernel launches). Duplicate
        timestamps are materialized once and share the returned VersionView
        object (concurrent users pin few distinct versions).

        A single distinct timestamp against a cold superlog takes the
        per-field select_at path instead: building the whole-store fused
        log for one version of a few fields would upload every field's
        cells (the update-then-read checkpoint/search workloads) — and,
        after a lazy load, would read every on-disk segment rather than
        just the requested fields' ranges.

        Args:
          ts_list: timestamps to materialize (duplicates share one view).
          fields: field subset (default: all).
          key_filter: regex (bytes-matched) or predicate over row keys.
          include_deleted: include tombstoned-but-once-alive rows.
          cancel: optional zero-arg callable polled between stages; when
            it returns True the query raises ``OperationCancelled`` (the
            store is untouched — queries never mutate).
          trace: optional dict accumulating per-stage wall seconds under
            ``"scan"`` (superlog build + batched masked-cumsum + exists
            resolution), ``"gather"`` (fused value gathers) and
            ``"materialize"`` (view assembly). Additive across calls.

        Returns:
          list[VersionView] aligned with ``ts_list``.

        Raises:
          KeyError: an unknown field name.
          OperationCancelled: ``cancel`` fired at a cancellation point.
        """
        fields = list(fields) if fields is not None else list(self.fields)
        ts_list = [int(t) for t in ts_list]
        if not ts_list:
            return []
        _check_cancel(cancel)
        uniq = list(dict.fromkeys(ts_list))
        if len(uniq) == 1 and not self._superlog_fresh():
            v = self._get_version_cold(uniq[0], fields, key_filter,
                                       include_deleted, trace=trace)
            return [v] * len(ts_list)
        with StageTimer(trace, "scan"):
            sl = self.superlog()
            bcum = sl.boundary_cums(uniq)
            alive, ever = sl.exists_matrix(bcum)
        if include_deleted:
            alive = ever
        _check_cancel(cancel)
        with StageTimer(trace, "gather"):
            field_cnt = {name: sl.counts(name, bcum) for name in fields}
            sels = [self._filter_sel(np.nonzero(alive[qi])[0], key_filter)
                    for qi in range(len(uniq))]
            vals = {name: sl.gather_many(name, field_cnt[name], sels)
                    for name in fields}
        _check_cancel(cancel)
        with StageTimer(trace, "materialize"):
            by_t = {}
            for qi, (t, sel) in enumerate(zip(uniq, sels)):
                by_t[t] = VersionView(
                    ts=t, keys=[self.row_keys[r] for r in sel],
                    row_idx=sel.astype(np.int32),
                    values={name: vals[name][qi] for name in fields})
            return [by_t[t] for t in ts_list]

    def get_version(self, t: Timestamp, *, fields: Sequence[str] | None = None,
                    key_filter: str | Callable[[bytes], bool] | None = None,
                    include_deleted: bool = False) -> VersionView:
        return self.get_versions([t], fields=fields, key_filter=key_filter,
                                 include_deleted=include_deleted)[0]

    def _get_version_cold(self, t: Timestamp, fields: list[str],
                          key_filter, include_deleted: bool,
                          trace: dict | None = None) -> VersionView:
        """Single-version materialization over the requested fields' own
        CSR logs (no fused-superlog build)."""
        # "ever existed" = any EXISTS cell with ts <= t; the found flag
        # matches _SuperLog.exists_matrix exactly (a windowed
        # changed_counts(-1, t) would drop cells at negative ts)
        with StageTimer(trace, "scan"):
            vals, found = self.exists_log.select_at(self.n_rows, t)
            alive = found if include_deleted else (vals[:, 0] > 0) & found
            sel = self._filter_sel(np.nonzero(alive)[0], key_filter)
        with StageTimer(trace, "gather"):
            values = {}
            for name in fields:
                vals, _found = self.fields[name].log.select_at(self.n_rows, t)
                values[name] = vals[sel]
        with StageTimer(trace, "materialize"):
            return VersionView(ts=t, keys=[self.row_keys[r] for r in sel],
                               row_idx=sel.astype(np.int32), values=values)

    # -- get_increment / get_increments (§III.C) -------------------------------
    def get_increments(self, pairs: Sequence[tuple[Timestamp, Timestamp]], *,
                       significant_fields: Sequence[str] | None = None,
                       fields: Sequence[str] | None = None) -> list[Increment]:
        """Entries whose significant fields changed in (t0, t1], for many
        (t0, t1) windows at once: one batched scan over the unique window
        endpoints serves every pair. Duplicate windows are computed once
        and share the returned Increment object (as get_versions does).

        Mirrors the paper's tool-specific change detection: a BLAST plugin
        passes significant_fields=["sequence"], so annotation-only updates
        produce an empty increment.

        Args:
          pairs: (t0, t1] windows (duplicates share one Increment).
          significant_fields: fields whose change marks a row updated
            (default: all fields).
          fields: fields materialized into ``values`` (default: all;
            pass ``[]`` for keys/kinds only).

        Returns:
          list[Increment] aligned with ``pairs`` (values at t1, zeroed
          for deleted rows).

        Raises:
          KeyError: an unknown field name.
        """
        sig = (list(significant_fields) if significant_fields is not None
               else list(self.fields))
        out_fields = list(fields) if fields is not None else list(self.fields)
        pairs = [(int(t0), int(t1)) for t0, t1 in pairs]
        if not pairs:
            return []
        upairs = list(dict.fromkeys(pairs))
        if len(upairs) == 1 and not self._superlog_fresh():
            inc = self._get_increment_cold(*upairs[0], sig=sig,
                                           out_fields=out_fields)
            return [inc] * len(pairs)
        uniq = list(dict.fromkeys(t for p in upairs for t in p))
        q_of = {t: i for i, t in enumerate(uniq)}
        sl = self.superlog()
        bcum = sl.boundary_cums(uniq)
        exists, _ever = sl.exists_matrix(bcum)
        cnt = {name: sl.counts(name, bcum)
               for name in dict.fromkeys(sig + out_fields)}
        sels, kinds = [], []
        for t0, t1 in upairs:
            i0, i1 = q_of[t0], q_of[t1]
            changed = np.zeros(self.n_rows, bool)
            for name in sig:
                changed |= (cnt[name][i1] - cnt[name][i0]) > 0
            e0, e1 = exists[i0], exists[i1]
            new = e1 & ~e0
            deleted = e0 & ~e1
            updated = e1 & e0 & changed
            sel = np.nonzero(new | deleted | updated)[0]
            kind = np.zeros(len(sel), np.int8)
            kind[new[sel]] = KIND_NEW
            kind[updated[sel]] = KIND_UPDATED
            kind[deleted[sel]] = KIND_DELETED
            sels.append(sel)
            kinds.append(kind)
        vals = {name: sl.gather_many(name, [cnt[name][q_of[t1]]
                                            for _, t1 in upairs], sels)
                for name in out_fields}
        by_pair = {}
        for qi, ((t0, t1), sel, kind) in enumerate(zip(upairs, sels, kinds)):
            values = {}
            for name in out_fields:
                v = vals[name][qi]
                v[kind == KIND_DELETED] = 0
                values[name] = v
            by_pair[(t0, t1)] = Increment(
                t0=t0, t1=t1, keys=[self.row_keys[r] for r in sel],
                row_idx=sel.astype(np.int32), kind=kind, values=values)
        return [by_pair[p] for p in pairs]

    def get_increment(self, t0: Timestamp, t1: Timestamp, *,
                      significant_fields: Sequence[str] | None = None,
                      fields: Sequence[str] | None = None) -> Increment:
        return self.get_increments([(t0, t1)],
                                   significant_fields=significant_fields,
                                   fields=fields)[0]

    def _get_increment_cold(self, t0: Timestamp, t1: Timestamp, *,
                            sig: list[str], out_fields: list[str]) -> Increment:
        """Single-window increment over the involved fields' own CSR logs
        (no fused-superlog build)."""
        changed = np.zeros(self.n_rows, bool)
        for name in sig:
            changed |= self.fields[name].log.changed_counts(
                self.n_rows, t0, t1) > 0
        e0 = self.exists_at(t0)
        e1 = self.exists_at(t1)
        new = e1 & ~e0
        deleted = e0 & ~e1
        updated = e1 & e0 & changed
        sel = np.nonzero(new | deleted | updated)[0]
        kind = np.zeros(len(sel), np.int8)
        kind[new[sel]] = KIND_NEW
        kind[updated[sel]] = KIND_UPDATED
        kind[deleted[sel]] = KIND_DELETED
        values = {}
        for name in out_fields:
            vals, _ = self.fields[name].log.select_at(self.n_rows, t1)
            v = vals[sel]
            v[kind == KIND_DELETED] = 0
            values[name] = v
        return Increment(t0=t0, t1=t1, keys=[self.row_keys[r] for r in sel],
                         row_idx=sel.astype(np.int32), kind=kind,
                         values=values)

    # -- compaction (production housekeeping; paper §III.E leaves retention
    # to "a cron job" — at fleet scale the cell log needs real compaction) --
    def compact(self, before_ts: Timestamp, *, label: str = "",
                path: str | None = None) -> dict:
        """Collapse every row's cell history with ts <= before_ts into a
        single base cell at before_ts. Versions > before_ts are preserved
        exactly; get_version(t) for t >= before_ts is unchanged (older
        pinned versions are the retention cost, as with any compaction).

        Args:
          before_ts: compaction horizon (inclusive).
          label: label for the synthetic base release in ``versions``.
          path: optional store directory — when given, the on-disk segments
            are rewritten too (covered segments replaced by a base segment,
            segments entirely above ``before_ts`` retained untouched; see
            ``segments.compact_on_disk``).

        Returns:
          dict with ``cells_dropped`` / ``versions_kept`` and, when ``path``
          is given, the on-disk rewrite stats (``segments_written``,
          ``segments_retained``, ``bytes_written``, ...).
        """
        # captured before rechaining: compact_on_disk proves the on-disk
        # manifest is an ancestor of THIS history (not a same-shaped
        # divergent store's) against the pre-compaction chain
        pre_digests = list(self._version_digests)
        dropped = 0
        for col in list(self.fields.values()) + [self.exists_log]:
            vals, tss, ptr = col.csr(self.n_rows) if isinstance(col, _CellLog) \
                else col.log.csr(self.n_rows)
            log = col if isinstance(col, _CellLog) else col.log
            if len(tss) == 0:
                continue
            base_vals, base_found = log.select_at(self.n_rows, before_ts)
            # the horizon mask + value rewrite run on the store's device;
            # byte-identical to the host oracle, pinned by the parity tests
            new_vals, new_tss, new_rows, new_ptr = kops.compact_rewrite(
                vals, tss, np.asarray(ptr), base_vals, base_found,
                before_ts, self.n_rows, device=self.device)
            dropped += len(tss) - len(new_tss)
            log._csr = (new_vals, new_tss, new_rows)
            log._chunks = []
            log._row_ptr = new_ptr
            log._n_rows_at_build = self.n_rows
        # collapse the updates-table prefix into one synthetic base release
        kept = [v for v in self.versions if v.ts > before_ts]
        n_base = int(self.exists_at(before_ts).sum())
        base = VersionInfo(ts=before_ts, label=label or f"compact@{before_ts}",
                           n_entries=n_base, n_new=n_base, n_updated=0,
                           n_deleted=0)
        self.versions = [base] + kept
        # the seed carries the pre-compaction content digest forward, so
        # divergent histories stay distinguishable after compaction too
        self._rechain_digests(hashlib.sha256(
            f"compact|{before_ts}|{self._history_digest}".encode())
            .hexdigest()[:16])
        self._invalidate_log()
        stats = {"cells_dropped": dropped, "versions_kept": len(kept) + 1}
        if path is not None:
            from . import segments
            stats.update(segments.compact_on_disk(
                self, path, before_ts, prior_digests=pre_digests))
        return stats

    # -- persistence: segmented, append-only layout (core/segments.py) -------
    def save(self, path: str, *, force_full: bool = False) -> dict:
        """Persist to the segmented on-disk layout at ``path`` (the JAX
        package's format: either package opens what the other saved).

        Incremental when the directory already holds a manifest that is a
        prefix of this store (same name/schema/keys/version history): only
        cells newer than the manifest's ``saved_through_ts`` are written,
        one segment per changed field — bytes written are O(new cells),
        independent of total history size. Anything else (first save,
        post-compaction, divergent history, ``force_full=True``) is a full
        rewrite that also migrates/removes legacy monolithic snapshots.
        Segments are chain-packed on the store's device.

        Args:
          path: store directory (created if missing).
          force_full: skip the incremental check and rewrite everything.

        Returns:
          dict with ``mode`` ("incremental" | "full"), ``segments_written``,
          ``bytes_written`` (segments + manifest written by THIS call),
          ``raw_bytes`` / ``packed_bytes`` (pre/post chain-packing sizes of
          the written cells), and ``disk_bytes`` (total store footprint).
        """
        from . import segments
        return segments.save_store(self, path, force_full=force_full)

    @classmethod
    def load(cls, path: str, *, lazy: bool = True,
             device=None) -> "VersionedStore":
        """Open a store directory (segmented manifest, or a legacy
        monolithic snapshot for backward compatibility), written by either
        package.

        Args:
          path: directory written by ``save`` (or a legacy snapshot).
          lazy: when True (default), segment files are only stat-checked
            (existence + exact size, so torn writes fail fast) and attached
            as pending handles — their cells are read the first time a
            query's timestamp bound reaches them, and head state is rebuilt
            on the first mutation. ``lazy=False`` materializes everything
            eagerly.
          device: where the reopened store runs, as for the constructor:
            None is the CUDA card (and raises without one); ``"cpu"`` runs
            the kernels' plain torch versions on the host.

        Returns:
          A fully functional VersionedStore.

        Raises:
          FileNotFoundError: no manifest or legacy snapshot at ``path``.
          segments.CorruptSegmentError: a listed segment is missing or
            truncated (lazy) / fails its checksum (on read).
        """
        from . import segments
        return segments.load_store(cls, path, lazy=lazy, device=device)

    # -- carrying a store across (core/state.py) ------------------------------
    def to_state(self) -> dict:
        """The store as plain Python and numpy values (see core/state.py)."""
        from .state import to_state
        return to_state(self)

    @classmethod
    def from_state(cls, state: Mapping, *, device=None) -> "VersionedStore":
        """A store rebuilt from ``to_state`` output (or the same arrays read
        out of a JAX-package store) on ``device``; heads rebuild lazily."""
        from .state import from_state
        return from_state(cls, state, device=device)
