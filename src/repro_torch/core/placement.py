"""Shard->device placement: device-parallel scatter-gather execution.

The paper's scalability story is many HBase region servers answering in
parallel (§II.B/§V); ``ShardedStore`` (core/shard.py) reproduces the
partitioning, and this module supplies the parallelism. The per-shard
batched-select scans collapse into stacked launches over a cross-shard
copy of the shards' fused ts arrays
(kernels/batched_select.stacked_boundary_select), so batched
``get_versions`` / ``get_increments`` pay one scan where the serial path
pays one per shard.

Execution modes, planned by :func:`plan_placement`:

  * ``mesh`` — at least one device per shard: shard s is pinned to
    ``devices[s]``. The stacked rows of the shards on one device scan in
    one launch there (the JAX package runs one ``shard_map`` over a
    ``("shard",)`` mesh instead), every device's launch is issued before
    any result is read, and the per-device results are gathered on the
    host. Value materialization then pays ONE fused cross-shard gather
    per field (``take_cells``) instead of one per (shard, field).
  * ``stacked`` — fewer devices than shards but parallelism forced
    (``GESTORE_PARALLEL=1`` or an explicit plan): the same single stacked
    launch and fused gathers on the store's device. It saves the
    per-shard launches, not device time.
  * ``serial`` — the per-shard ``get_versions`` loop: the default whenever
    the host has fewer devices than shards (one card and 4 shards plan
    serial), and the explicit opt-out (``GESTORE_PARALLEL=0``).

Devices: ``plan_placement(devices=None)`` plans over the CUDA cards; a
store on the CPU plans over ``[cpu]`` (core/shard.py passes it).

Every mode returns byte-identical results: the stacked scan computes the
exact per-shard boundary cumsums the serial path does, so the choice is
pure placement and composes with the ``log_epoch`` plan-cache contract
unchanged.

Placement never moves a shard. The shards' logs, heads and superlogs stay
on the store's device; a :class:`PlacedSuperLog` is a separate copy built
from the shards' host arrays and uploaded to its own targets (each mesh
device's stacked rows there, the fused value arrays on the store's
device). The JAX package repins each shard's ``device`` instead, which
there steers only the superlog's uploads; in this port a store's
``device`` also fixes where its cell logs scan, so repinning it would
split one shard across two devices.

Residency: a :class:`PlacedSuperLog` is built from the resident shards
(the facade forces residency first, exactly like the serial path) and is
keyed on the tuple of shard epochs. A spill freezes a shard's epoch and
the lazy reload floors back to it, so an unchanged epoch tuple means the
cached stacked copy is still byte-valid. The facade's ``drop_superlog`` /
``nbytes`` account for the stacked device buffers.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..kernels import launch as klaunch
from ..kernels._compat import bits_view, from_bits
from ..kernels.batched_select import scan_bucket, stacked_boundary_select
from ..launch.mesh import make_shard_mesh
from ..obs import kerneltel
from .store import _SuperLog, _clamp_ts

#: env override: "0"/"off"/"serial" forces serial, "1"/"on"/"parallel"
#: forces the stacked launch even with fewer devices than shards.
PARALLEL_ENV = "GESTORE_PARALLEL"

_FORCE_ON = ("1", "on", "parallel", "stacked", "force")
_FORCE_OFF = ("0", "off", "serial")


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """One shard->device execution plan (see module docstring for modes)."""
    mode: str                 # "mesh" | "stacked" | "serial"
    devices: tuple = ()       # shard id -> torch.device (mesh mode only)

    @property
    def parallel(self) -> bool:
        return self.mode != "serial"

    def device_for(self, shard: int):
        """Pinned device of ``shard``, or None (the store's device)."""
        return self.devices[shard] if shard < len(self.devices) else None


def plan_placement(n_shards: int, *, devices=None,
                   force: str | None = None) -> ShardPlacement:
    """Plan shard->device placement for an ``n_shards``-way store.

    Args:
      n_shards: shard count of the facade.
      devices: explicit device list (default: every CUDA card, none
        without one).
      force: override the auto decision — any of ``_FORCE_ON`` forces the
        stacked/mesh parallel path, ``_FORCE_OFF`` forces serial; None
        reads the ``GESTORE_PARALLEL`` env var, then auto-plans: mesh when
        there is at least one device per shard, else serial.
    """
    if force is None:
        force = os.environ.get(PARALLEL_ENV)
    if force is not None:
        force = str(force).strip().lower() or None
    if n_shards < 2 or force in _FORCE_OFF:
        return ShardPlacement("serial")
    devs = make_shard_mesh(n_shards, devices)
    if devs is not None:
        return ShardPlacement("mesh", devs)
    if force in _FORCE_ON:
        return ShardPlacement("stacked")
    return ShardPlacement("serial")


class PlacedSuperLog:
    """Cross-shard stacked fused-superlog state for one facade epoch.

    Holds (S, Cmax) stacked per-shard fused ts rows (padded with int32
    max, which no clamped query timestamp can reach) and (S, Bmax) stacked
    CSR boundary positions (zero-padded; boundary 0 reads count 0), cut
    into one block of rows per device: every shard on one block in
    ``stacked`` mode, the shards pinned to each device in ``mesh`` mode.
    ``boundary_cums`` then answers every shard's
    ``_SuperLog.boundary_cums`` with one launch per block.

    Immutable once built; the facade caches one instance keyed on
    ``epochs`` (the per-shard ``log_epoch`` tuple) and rebuilds whenever
    any shard's epoch moves.
    """

    def __init__(self, superlogs, placement: ShardPlacement,
                 device: torch.device):
        self.epochs = tuple(sl.epoch for sl in superlogs)
        self.device = device  # the store's: fused value arrays live here
        self.b_widths = [len(sl.boundaries) for sl in superlogs]
        self.n_cells = sum(sl.n_cells for sl in superlogs)
        # per-field fused cross-shard value arrays, uploaded lazily on the
        # first gather of that field (name -> (dev, offs, total, w, dtype));
        # content validity follows from the epoch contract, so rebuild-time
        # callers pass their CURRENT superlog list and never retain ours
        self._fused: dict[str, tuple] = {}
        s = len(superlogs)
        # the JAX package's pow2 buckets, so both hold the same stacked
        # device bytes
        self.cmax = scan_bucket(max((sl.n_cells for sl in superlogs),
                                    default=0))
        self.bmax = klaunch.pow2_bucket(max(self.b_widths, default=0),
                                        floor=8)
        ts = np.full((s, self.cmax), np.iinfo(np.int32).max, np.int32)
        bnd = np.zeros((s, self.bmax), np.int32)
        for i, sl in enumerate(superlogs):
            if sl.ts_host is not None:
                ts[i, : sl.n_cells] = sl.ts_host
            bnd[i, : self.b_widths[i]] = sl.boundaries.astype(np.int32)
        # device -> the shard rows it scans, in shard order
        rows: dict[torch.device, list[int]] = {}
        for i in range(s):
            dev = (placement.device_for(i) if placement.mode == "mesh"
                   else None)
            rows.setdefault(device if dev is None else dev, []).append(i)
        self._blocks = [(dev, ids, torch.as_tensor(ts[ids], device=dev),
                         torch.as_tensor(bnd[ids], device=dev))
                        for dev, ids in rows.items()]

    def boundary_cums(self, ts_list) -> list[np.ndarray]:
        """Per-shard (Q, B_s) boundary cumsums for ``ts_list`` — the exact
        numbers each shard's ``_SuperLog.boundary_cums`` would return,
        from one stacked launch per device block."""
        qs = np.asarray([_clamp_ts(t) for t in ts_list], np.int32)
        if self.n_cells == 0 or not len(qs):
            return [np.zeros((len(qs), w), np.int32) for w in self.b_widths]
        q = len(qs)
        # bucket the query axis too (repeat the last query; extra columns
        # are sliced off), as the JAX package does
        q_pad = klaunch.pow2_bucket(q, floor=8)
        qs_in = qs if q_pad == q else np.concatenate(
            [qs, np.full(q_pad - q, qs[-1], np.int32)])
        s = len(self.b_widths)
        # stacked traffic model: logical counts the real per-shard cells
        # and boundaries; padded counts the bucketed (S, Cmax)/(S, Q, Bmax)
        # stacked shapes that actually move
        b_sum = sum(self.b_widths)
        with kerneltel.launch("batched_select",
                              nbytes=4 * (self.n_cells + q * self.n_cells
                                          + 2 * q * b_sum),
                              flops=2 * q * self.n_cells,
                              padded_nbytes=4 * (s * self.cmax
                                                 + s * q_pad * self.cmax
                                                 + 2 * s * q_pad
                                                 * self.bmax)):
            # issue every block's launch before reading any result back,
            # so blocks on different cards scan at the same time
            outs = [(ids, stacked_boundary_select(
                        ts, torch.as_tensor(qs_in, device=dev), bnd))
                    for dev, ids, ts, bnd in self._blocks]
            out = np.empty((s, q_pad, self.bmax), np.int32)
            for ids, o in outs:
                out[ids] = o.cpu().numpy()
        return [out[i, :q, : w] for i, w in enumerate(self.b_widths)]

    # -- fused cross-shard value gathers --------------------------------------
    def _fused_field(self, name: str, superlogs) -> tuple:
        """Cross-shard concatenation of one field's cell values' bits: a
        single device tensor with per-shard cell offsets, so a
        materialization wave pays ONE gather per field instead of one per
        (shard, field). The host copies come from the caller's current
        superlogs (equal epochs imply identical cells, so the cached upload
        stays byte-valid across spill/reload); only the device tensor and
        offsets are cached."""
        ent = self._fused.get(name)
        if ent is None:
            f0 = superlogs[0].fields[name]
            parts, offs, off = [], [], 0
            for sl in superlogs:
                f = sl.fields[name]
                offs.append(off)
                if f.vals_host is not None:
                    parts.append(f.vals_host)
                off += f.n_cells
            dev = None
            if off:
                dev = torch.as_tensor(bits_view(
                    parts[0] if len(parts) == 1 else np.concatenate(parts)),
                    device=self.device)
            ent = (dev, offs, off, f0.width, f0.dtype)
            self._fused[name] = ent
        return ent

    def field_offsets(self, name: str, superlogs) -> list[int]:
        """Per-shard cell offset of ``name`` in the fused value array."""
        return self._fused_field(name, superlogs)[1]

    def take_cells(self, name: str, idx: np.ndarray, keep: np.ndarray,
                   lens, superlogs) -> list[np.ndarray]:
        """One fused device gather for a whole wave: ``idx`` holds global
        cell positions (already permuted into every query's final merged
        row order, queries back to back with per-query ``lens``) and
        ``keep`` masks rows whose value must be zeroed (no cell at the
        query time / deleted rows) — the same semantics as
        ``_SuperLog.gather_finalize``."""
        dev, _offs, total, width, dtype = self._fused_field(name, superlogs)
        if dev is None or len(idx) == 0:
            return [np.zeros((int(n), width), dtype) for n in lens]
        got = dev.index_select(0, torch.as_tensor(
            np.clip(idx, 0, total - 1), device=self.device))
        got.masked_fill_(~torch.as_tensor(keep, device=self.device)[:, None],
                         0)
        out = from_bits(got, dtype)
        cum = np.cumsum([0] + list(lens))
        return [out[cum[i]: cum[i + 1]] for i in range(len(lens))]

    def exists_matrices(self, bcums, superlogs) -> list[tuple]:
        """Per-shard ``(alive, ever)`` — ``_SuperLog.exists_matrix`` for
        every shard from ONE fused EXISTS gather instead of S launches."""
        name = _SuperLog.EXISTS
        dev, offs, total, _w, _d = self._fused_field(name, superlogs)
        cnts, evers, idxs = [], [], []
        for s, sl in enumerate(superlogs):
            f = sl.fields[name]
            cnt = sl.counts(name, bcums[s])
            cnts.append(cnt)
            evers.append(cnt > 0)
            idxs.append(offs[s] + np.clip(f.ptr[None, :-1] + cnt - 1, 0,
                                          max(f.n_cells - 1, 0)))
        if dev is None:
            return [(np.zeros_like(e), e) for e in evers]
        idx = np.clip(np.concatenate(idxs, axis=1), 0, total - 1)
        v = dev[:, 0][torch.as_tensor(idx, device=self.device)].cpu().numpy()
        out, col = [], 0
        for ever in evers:
            n = ever.shape[1]
            out.append((((v[:, col: col + n] > 0) & ever), ever))
            col += n
        return out

    def nbytes(self) -> int:
        """Device bytes held by the stacked scan operands plus the fused
        per-field value uploads (facade accounting)."""
        n = 0
        for _dev, _ids, ts, bnd in self._blocks:
            n += ts.numel() * ts.element_size()
            n += bnd.numel() * bnd.element_size()
        for dev, *_ in self._fused.values():
            if dev is not None:
                n += dev.numel() * dev.element_size()
        return n
