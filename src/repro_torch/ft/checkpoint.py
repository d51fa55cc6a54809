"""Delta-compressed versioned checkpoints, and the streaming ingest's
journal.

``CheckpointManager`` applies the paper's technique to training state: a
checkpoint is a meta-database release. Each leaf is cut into rows of
``CHUNK_W`` f32 lanes of a ``VersionedStore``; saving step T is
``store.update(ts=T, ...)`` (the fingerprint kernel finds the rows that
changed), and the store's save chain-packs float rows by XOR against
their previous version (the codec kernel) before deflate. Restoring any
step is ``get_version(T)``. Saves are asynchronous: the leaves are copied
to the host on the caller's thread, the update and the disk write run on
a worker thread. The directory is the JAX package's (``meta.json`` and
the store's segmented layout, leaves named by ``jax.tree_util.keystr``
paths), so either package opens what the other wrote.

``IngestJournal``, the port's copy of the JAX package's: parsed release
chunks are journaled to a sidecar directory with an atomically rewritten
manifest, so a crash mid-release resumes by replaying journaled chunks
over the pre-release store instead of re-parsing the whole file. The
files are the JAX package's, byte for byte.
"""
from __future__ import annotations

import io
import json
import os
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

CHUNK_W = 2048

JOURNAL_FORMAT = "gestore-ingest-journal-v1"
JOURNAL_NAME = "JOURNAL.json"


def _fsync_write(path: str, data: bytes) -> None:
    """Write ``data`` atomically (tmp + fsync + rename + dir fsync)."""
    from ..core.segments import _fsync_dir
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class IngestJournal:
    """Durable chunk journal for one in-flight streaming release.

    Layout under ``root``: ``JOURNAL.json`` (the manifest — release
    identity, a store *digest watermark* captured at session start, and
    the applied-chunk list with source offsets) plus one
    ``chunk-NNNNN.npz`` of parsed rows per applied chunk. The chunk file
    is fsynced BEFORE the manifest lists it, so every chunk the manifest
    names is replayable. The watermark (history digest + last committed
    ts + total cell count) pins the exact pre-release store state the
    journal's chunks apply over: a resume against a store that moved on
    — or one dirtied by a half-applied release — refuses instead of
    corrupting.

    The journal is *sidecar* state: release cells only reach the store
    directory once, at the post-``finish()`` save. Journaling partially
    applied cells through the store's own incremental save is unsound —
    all of one release's cells share a timestamp, so a second mid-release
    save would re-extract (duplicate) the cells of the first.
    """

    def __init__(self, root: str, meta: dict):
        self.root = root
        self.meta = meta

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def begin(cls, root: str, *, store: str, ts: int, label: str,
              full_release: bool, watermark: dict) -> "IngestJournal":
        """Start a fresh journal (clearing any stale one at ``root``)."""
        j = cls(root, {"format": JOURNAL_FORMAT, "store": store,
                       "ts": int(ts), "label": label,
                       "full_release": bool(full_release),
                       "watermark": watermark, "chunks": []})
        if os.path.isdir(root):
            j.clear()
        os.makedirs(root, exist_ok=True)
        j._write_manifest()
        return j

    @classmethod
    def open(cls, root: str) -> "IngestJournal | None":
        """The journal at ``root``, or None when absent/unreadable."""
        p = os.path.join(root, JOURNAL_NAME)
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                meta = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
        if meta.get("format") != JOURNAL_FORMAT:
            return None
        return cls(root, meta)

    def clear(self) -> None:
        """Delete the journal (manifest first, so a crash mid-clear can
        never leave a manifest naming deleted chunk files)."""
        p = os.path.join(self.root, JOURNAL_NAME)
        if os.path.exists(p):
            os.remove(p)
        if os.path.isdir(self.root):
            for name in os.listdir(self.root):
                if name.startswith("chunk-") and name.endswith(".npz"):
                    os.remove(os.path.join(self.root, name))

    # -- chunks --------------------------------------------------------------
    @property
    def chunks(self) -> list[dict]:
        return self.meta["chunks"]

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.root, f"chunk-{idx:05d}.npz")

    def record_chunk(self, keys: list[bytes], table: dict, *,
                     source_offset: int | None, flush: bool = True) -> int:
        """Durably append one parsed chunk; returns its index. The npz
        commits before the manifest references it. ``flush=False`` defers
        the manifest rewrite (call ``flush()``); a crash in between
        re-parses the deferred chunks from their source offsets — the npz
        bytes are durable either way, the manifest just doesn't name them
        yet."""
        idx = len(self.chunks)
        buf = io.BytesIO()
        np.savez(buf, __keys__=np.array(keys, dtype="S"),
                 **{f"f_{n}": v for n, v in table.items()})
        _fsync_write(self._chunk_path(idx), buf.getvalue())
        self.chunks.append({"idx": idx, "n_entries": len(keys),
                            "source_offset": source_offset})
        if flush:
            self._write_manifest()
        return idx

    def flush(self) -> None:
        """Commit the manifest naming every recorded chunk."""
        self._write_manifest()

    def load_chunk(self, idx: int) -> tuple[list[bytes], dict]:
        with np.load(self._chunk_path(idx)) as z:
            keys = [bytes(k) for k in z["__keys__"]]
            table = {n[2:]: z[n] for n in z.files if n.startswith("f_")}
        return keys, table

    def entries_applied(self) -> int:
        return sum(c["n_entries"] for c in self.chunks)

    def resume_offset(self) -> int | None:
        """Source offset parsing resumes from, or None when the parser
        journaled no offsets (block formats resume by record skip)."""
        if not self.chunks:
            return 0
        off = self.chunks[-1]["source_offset"]
        return None if off is None else int(off)

    def _write_manifest(self) -> None:
        _fsync_write(os.path.join(self.root, JOURNAL_NAME),
                     json.dumps(self.meta).encode())


def _leaf_rows(path: str, arr: np.ndarray):
    """Flatten a leaf into (keys, (N, CHUNK_W) f32 rows, pad)."""
    flat = np.asarray(arr, np.float32).reshape(-1)
    pad = (-len(flat)) % CHUNK_W
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    rows = flat.reshape(-1, CHUNK_W)
    keys = [f"{path}#{i}".encode() for i in range(len(rows))]
    return keys, rows, pad


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as an f32 host array (what the rows hold) and its dtype's
    name as the JAX package writes it (``float32``, ``bfloat16``, ...).
    A DTensor is gathered whole first (a collective: every rank of its
    mesh calls this)."""
    from ..sharding.rules import is_dtensor
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return (x.detach().to(torch.float32).cpu().numpy(),
                str(x.dtype).removeprefix("torch."))
    arr = np.asarray(x)
    return arr.astype(np.float32), str(arr.dtype)


class CheckpointManager:
    """Versioned checkpoints of a tree of tensors under ``root``.

    ``device``: where the checkpoint store's kernels run (None: the CUDA
    card; ``"cpu"`` for the plain versions on the host)."""

    def __init__(self, root: str, *, async_save: bool = True, device=None):
        from ..core.store import FieldSchema, VersionedStore
        self.root = root
        self.device = device
        os.makedirs(root, exist_ok=True)
        self.store = VersionedStore(
            "ckpt", [FieldSchema("w", CHUNK_W, "float32")], device=device)
        self.meta: dict[str, Any] = {"leaves": {}, "steps": []}
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_info = None
        self._load_existing()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state) -> dict:
        """Record ``state`` (a tree of tensors or arrays) as version
        ts=step. The leaves are copied to the host before this returns.

        A sharded tree (DTensor leaves) is saved as the same host rows:
        every rank gathers each leaf whole, and rank 0 alone writes."""
        from ..sharding.rules import is_dtensor
        from ..train.tree import leaves_with_path
        self.wait()
        flat = leaves_with_path(state)
        host = [(path, *_host(x)) for path, x in flat]
        if any(is_dtensor(x) for _, x in flat) and dist.get_rank() != 0:
            return {"async": self.async_save, "step": step, "writer": False}

        def work():
            keys: list[bytes] = []
            rows: list[np.ndarray] = []
            for path, arr, dtype in host:
                k, r, _pad = _leaf_rows(path, arr)
                keys.extend(k)
                rows.append(r)
                self.meta["leaves"][path] = {"shape": list(arr.shape),
                                             "dtype": dtype}
            table = {"w": np.concatenate(rows) if rows else
                     np.zeros((0, CHUNK_W), np.float32)}
            info = self.store.update(step, keys, table, label=f"step{step}")
            self.meta["steps"].append(step)
            self._persist()
            self._last_info = info

        if self.async_save:
            def guarded():
                try:
                    work()
                except BaseException as e:  # re-raised by wait()
                    self._error = e
            self._worker = threading.Thread(target=guarded, daemon=True)
            self._worker.start()
            return {"async": True, "step": step}
        work()
        return {"async": False, "step": step,
                "changed": self._last_info.n_updated + self._last_info.n_new}

    def wait(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ----------------------------------------------------------------
    def steps(self) -> list[int]:
        self.wait()
        return sorted(self.meta["steps"])

    def restore(self, step: int, like=None, mesh=None, shardings=None):
        """The tree at version ``step``: with ``like``, a tree of its
        structure whose leaves are tensors on the devices of ``like``'s
        leaves; without, ``{keystr path: CPU tensor}``. Each leaf has the
        dtype it was saved with.

        With ``mesh`` and ``shardings`` (a tree of ``NamedSharding``s of
        ``like``'s structure, ``sharding.tree_shardings``), each leaf is
        distributed onto ``mesh`` as its sharding says: restoring onto
        another mesh shape than the one that saved is the elastic
        resharding path (the rows are mesh-agnostic). Every rank calls
        it; the ranks that did not write read the store rank 0 wrote."""
        from ..train.tree import leaves_with_path, tree_unflatten
        self.wait()
        if mesh is not None:
            if dist.is_initialized():
                dist.barrier()
            if step not in self.meta["steps"]:
                self._load_existing()
        view = self.store.get_version(step, fields=["w"])
        by_key = dict(zip(view.keys, view.values["w"]))
        leaves = {}
        for path, info in self.meta["leaves"].items():
            n = int(np.prod(info["shape"])) if info["shape"] else 1
            n_chunks = -(-n // CHUNK_W)
            parts = [by_key[f"{path}#{i}".encode()] for i in range(n_chunks)]
            flat = (np.concatenate(parts)[:n] if parts
                    else np.zeros(0, np.float32))
            leaves[path] = torch.from_numpy(
                np.ascontiguousarray(flat.reshape(info["shape"]))).to(
                    getattr(torch, info["dtype"]))
        if like is None:
            return leaves
        flat_like = leaves_with_path(like)
        if shardings is None:
            return tree_unflatten(like, [leaves[p].to(x.device)
                                         for p, x in flat_like])
        from ..sharding.rules import distribute_tree
        dev = torch.device(mesh.device_type)
        return distribute_tree(tree_unflatten(
            like, [leaves[p].to(dev) for p, _ in flat_like]), shardings)

    # -- persistence -------------------------------------------------------------
    def _persist(self) -> None:
        self.store.save(os.path.join(self.root, "store"))
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump(self.meta, f)

    def _load_existing(self) -> None:
        from ..core.store import VersionedStore
        mp = os.path.join(self.root, "meta.json")
        sp = os.path.join(self.root, "store")
        if os.path.exists(mp) and os.path.exists(sp):
            with open(mp) as f:
                self.meta = json.load(f)
            self.store = VersionedStore.load(sp, device=self.device)

    def stats(self) -> dict:
        self.wait()
        cells = sum(col.log.n_cells for col in self.store.fields.values())
        total_rows = self.store.n_rows
        return {"versions": len(self.meta["steps"]), "rows": total_rows,
                "cells": cells,
                "dedup_ratio": (total_rows * max(len(self.meta['steps']), 1))
                / max(cells, 1)}
