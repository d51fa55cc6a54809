"""The ingest journal of the streaming release ingest (core/ingest.py).

The port's copy of the ``IngestJournal`` part of ``repro.ft.checkpoint``:
parsed release chunks are journaled to a sidecar directory with an
atomically rewritten manifest, so a crash mid-release resumes by
replaying journaled chunks over the pre-release store instead of
re-parsing the whole file. The files are the JAX package's, byte for
byte. ``CheckpointManager`` (delta-compressed training checkpoints) comes
with the training slice.
"""
from __future__ import annotations

import io
import json
import os

import numpy as np

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
