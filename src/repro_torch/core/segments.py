"""Segmented on-disk version storage (paper §III.B/§IV: efficient storage
of many meta-database releases).

The port's copy of ``repro.core.segments``: the same layout, written byte
for byte as the JAX package writes it, so a store directory saved by
either package opens in the other. Segment packing runs on the store's
device (``kernels/delta_codec.chain_pack``, the ``delta_codec`` CUDA
kernel on a card); decoding a segment is host numpy.

The monolithic ``cells.npz`` snapshot the seed shipped rewrote every cell
on each ``save()`` and inflated the full history into RAM on ``load()``.
This module replaces it with an append-only segment layout:

    <root>/MANIFEST.json                  atomic commit point (tmp+replace)
    <root>/SEGMENTS.jsonl                 append-only segment index
    <root>/segments/<field>/<ts0>-<ts1>.npz   immutable, delta-packed

Each segment file holds the cells of ONE field (or the EXISTS log, stored
under the ``__exists__`` sentinel) whose timestamps fall in ``[ts0, ts1]``,
as three arrays: ``rows`` (C,) int32, ``ts`` (C,) int64, and ``vals``
(C, W) chain-packed by ``kernels/delta_codec.chain_pack`` (first cell of a
row chain raw, later cells as deltas, with integer narrowing). Chains never
cross segments, so every segment decodes independently — the property that
makes lazy loading possible.

The segment index (``SEGMENTS.jsonl``, or ``SEGMENTS.<gen>.jsonl`` after
a rewrite) holds one JSON line per segment ({field, path, ts0, ts1,
n_cells, kind, pack, nbytes, sha256}). It is append-only so that an
incremental save writes O(new segments) index bytes, not a rewrite of the
whole O(history) index.

``MANIFEST.json`` is the single commit point and records, besides the
store metadata (name, schema, keys, versions):

    "format":           "gestore-segments-v1"
    "saved_through_ts": highest cell timestamp covered by the committed
                        segments (the incremental-save watermark)
    "segment_index":    filename of the committed index
    "index_gen":        index generation (bumped by full rewrite/compact)
    "segment_count":    committed line count of the index
    "segments_bytes":   committed byte length of the index
    "segments_nbytes":  running total of committed segment file bytes
                        (keeps incremental-save stats O(new segments))

Durability protocol: segment files are written to ``.tmp``, fsynced, then
renamed (the manifest and index generations likewise, with a directory
fsync after the rename, so the commit survives power loss, not just
process crashes);
incremental saves append index lines (after truncating any uncommitted
tail to ``segments_bytes``); full rewrites and compactions write a NEW
index generation instead of touching the committed one; the manifest is
rewritten last, atomically, and only then are superseded files deleted.
A crash at any point therefore leaves the previous manifest — whose
``segments_bytes`` prefix of its own index generation is still intact —
loadable; stray appended lines, unreferenced index generations, and
orphan segment files are simply ignored. ``nbytes`` is checked against
``os.stat`` for every committed segment at load time and ``sha256`` on
first read, so torn or bit-flipped segment writes raise
``CorruptSegmentError`` instead of decoding garbage.

Save modes:
  * incremental — when the on-disk manifest is a *prefix* of the in-memory
    store (same name, schema-compatible, version-ts and key prefix), only
    cells with ts > ``saved_through_ts`` are written: one new segment per
    field that changed. Bytes written are O(new cells), independent of the
    total history size.
  * full rewrite — anything else (first save, post-compaction, divergent
    history). Also migrates legacy monolithic snapshots: the new layout is
    committed first, then stale ``cells.npz``/``meta.json`` are removed.

``compact_on_disk`` mirrors ``VersionedStore.compact`` on disk: covered
segments are replaced by one base segment (+ one gap segment for tail cells
whose original segments straddled the compaction point) while segments
entirely above ``before_ts`` are retained untouched.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import TYPE_CHECKING, Sequence

import numpy as np

from ..kernels.delta_codec import chain_pack, chain_unpack
from ..obs import RECORDER, REGISTRY
from ..obs.trace import StageTimer

if TYPE_CHECKING:  # avoid a circular import; store.py imports us lazily
    from .store import VersionedStore

FORMAT = "gestore-segments-v1"
MANIFEST_NAME = "MANIFEST.json"
SEGMENT_INDEX_NAME = "SEGMENTS.jsonl"
SEGMENT_DIR = "segments"
EXISTS_FIELD = "__exists__"
LEGACY_FILES = ("cells.npz", "meta.json")


class CorruptSegmentError(ValueError):
    """A segment file is missing, truncated, or fails its checksum."""


@dataclasses.dataclass(frozen=True)
class SegmentMeta:
    """One manifest entry describing an immutable on-disk segment."""
    field: str        # column name, or EXISTS_FIELD for the tombstone log
    path: str         # store-root-relative file path
    ts0: int          # min cell timestamp in the file
    ts1: int          # max cell timestamp in the file
    n_cells: int
    kind: str         # "delta" (incremental flush) | "base" (compaction)
    pack: dict        # chain_pack meta: mode/dtype/narrow
    nbytes: int       # exact file size (torn-write detection)
    sha256: str       # file digest (bit-rot detection, checked on read)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SegmentMeta":
        return cls(**d)


def fs_name(name: str) -> str:
    """Filesystem-safe directory name for a field or store name."""
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in name) or "_"


def store_dir_name(name: str) -> str:
    """Collision-free directory name for a store: when sanitization had to
    change the name, a digest suffix keeps distinct names (e.g. ``a/b`` vs
    ``a_b``) from sharing — and destroying — one directory."""
    safe = fs_name(name)
    if safe == name:
        return safe
    return f"{safe}-{hashlib.sha256(name.encode()).hexdigest()[:8]}"


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry after rename/create. Unlike
    data files, some filesystems reject opening or fsyncing directories,
    so failures here are swallowed rather than aborting the save."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# -- segment file I/O ---------------------------------------------------------

def write_segment(root: str, field: str, rows: np.ndarray, tss: np.ndarray,
                  vals: np.ndarray, *, kind: str = "delta",
                  tag: str = "", device=None) -> tuple[SegmentMeta, int]:
    """Chain-pack and atomically write one segment file; returns
    (meta, packed-array bytes before npz compression).

    ``rows``/``tss``/``vals`` must be non-empty and sorted by (row, ts) —
    the order ``_CellLog.cells_after`` and ``csr`` produce. ``tag`` goes
    into the filename: rewrites pass the index generation so their files
    can never overwrite a committed same-range segment of the previous
    generation (which must stay intact until the manifest commit).
    ``device`` is where the chain pack runs (None: the CUDA card).
    """
    assert len(tss) > 0, "empty segments are never written"
    # store_dir_name, not fs_name: field names that sanitize identically
    # ('a/b' vs 'a_b') must not write into each other's directory
    field_dir = store_dir_name(field)
    seg_dir = os.path.join(root, SEGMENT_DIR, field_dir)
    os.makedirs(seg_dir, exist_ok=True)
    ts0, ts1 = int(tss.min()), int(tss.max())
    packed, pack_meta = chain_pack(np.ascontiguousarray(vals),
                                   np.asarray(rows), device=device)
    rel = os.path.join(SEGMENT_DIR, field_dir, f"{ts0}-{ts1}{tag}.npz")
    path = os.path.join(root, rel)
    # serialize in memory so size + sha come from the buffer we wrote —
    # no read-back pass over the file we just created
    bio = io.BytesIO()
    np.savez_compressed(bio, rows=rows.astype(np.int32),
                        ts=tss.astype(np.int64), vals=packed)
    blob = bio.getvalue()
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        f.write(blob)
        # tmp+rename alone only survives application crashes; a power
        # failure can leave the renamed file empty unless its data was
        # synced first. fsync errors (e.g. EIO) must abort the save.
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # sync the whole new directory chain: seg_dir holds the file entry,
    # segments/ holds the (possibly just-created) <field> entry; the root's
    # segments/ entry is made durable by the manifest commit's root fsync
    _fsync_dir(seg_dir)
    _fsync_dir(os.path.join(root, SEGMENT_DIR))
    seg = SegmentMeta(field=field, path=rel, ts0=ts0, ts1=ts1,
                      n_cells=len(tss), kind=kind, pack=pack_meta,
                      nbytes=len(blob),
                      sha256=hashlib.sha256(blob).hexdigest())
    return seg, packed.nbytes


def read_segment(root: str, seg: SegmentMeta, dtype: np.dtype,
                 width: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Verify and decode one segment -> (rows, ts, vals).

    Raises:
      CorruptSegmentError: missing file, size mismatch (torn write), digest
        mismatch (bit rot), or cell-count mismatch vs the manifest.
    """
    path = os.path.join(root, seg.path)
    check_segment_stat(root, seg)
    # one disk read: hash the buffer, then decode it from memory
    with open(path, "rb") as f:
        blob = f.read()
    if hashlib.sha256(blob).hexdigest() != seg.sha256:
        raise CorruptSegmentError(f"segment {seg.path}: sha256 mismatch")
    with np.load(io.BytesIO(blob)) as z:
        rows, tss, packed = z["rows"], z["ts"], z["vals"]
    if len(rows) != seg.n_cells or len(tss) != seg.n_cells:
        raise CorruptSegmentError(
            f"segment {seg.path}: {len(rows)} cells != manifest {seg.n_cells}")
    vals = chain_unpack(packed, rows, seg.pack, np.dtype(dtype))
    return rows, tss, vals.reshape(seg.n_cells, width)


def check_segment_stat(root: str, seg: SegmentMeta) -> None:
    """Cheap existence + exact-size check (run for every segment at load
    time, so a torn write surfaces before any query touches the store)."""
    path = os.path.join(root, seg.path)
    if not os.path.exists(path):
        raise CorruptSegmentError(f"segment {seg.path}: missing")
    n = os.path.getsize(path)
    if n != seg.nbytes:
        raise CorruptSegmentError(
            f"segment {seg.path}: {n} bytes on disk != manifest {seg.nbytes}"
            " (torn write?)")


class SegmentHandle:
    """Lazy reference to one on-disk segment, attached to a ``_CellLog``.

    The log materializes a handle (splices its cells into the CSR) only
    when a query's timestamp bound reaches the segment's range."""

    __slots__ = ("root", "seg", "dtype", "width")

    def __init__(self, root: str, seg: SegmentMeta, dtype: np.dtype, width: int):
        self.root, self.seg, self.dtype, self.width = root, seg, dtype, width

    @property
    def ts0(self) -> int:
        return self.seg.ts0

    @property
    def ts1(self) -> int:
        return self.seg.ts1

    @property
    def n_cells(self) -> int:
        return self.seg.n_cells

    def materialize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        # instrument the CALLER, not read_segment itself: fault-injection
        # tests replace the module-level read_segment wholesale, and an
        # injected failure must still land in the flight recorder with
        # the active trace id attached
        try:
            with StageTimer(None, "segment_read"):
                return read_segment(self.root, self.seg, self.dtype,
                                    self.width)
        except Exception as e:  # noqa: BLE001 — recorded, then re-raised
            REGISTRY.counter("segments.read_errors").inc()
            RECORDER.record("segment_read_error", path=self.seg.path,
                            root=self.root, error=repr(e))
            raise


# -- manifest I/O -------------------------------------------------------------

def read_manifest(root: str) -> dict | None:
    """Parsed MANIFEST.json, or None when absent/unparseable (callers treat
    both as "no segmented store here")."""
    p = os.path.join(root, MANIFEST_NAME)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            man = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    return man if man.get("format") == FORMAT else None


def write_manifest(root: str, man: dict) -> int:
    """Atomically commit the manifest; returns its byte size."""
    p = os.path.join(root, MANIFEST_NAME)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, p)
    _fsync_dir(root)
    return os.path.getsize(p)


def _index_name(man: dict) -> str:
    return man.get("segment_index", SEGMENT_INDEX_NAME)


def read_segment_index(root: str, man: dict) -> list[SegmentMeta]:
    """The committed prefix of the manifest's segment index (exactly
    ``segments_bytes`` bytes / ``segment_count`` lines; anything beyond is
    an uncommitted tail from an interrupted save and is ignored).

    Raises:
      CorruptSegmentError: the committed prefix is shorter than the
        manifest claims or contains invalid JSON.
    """
    count, nbytes = man["segment_count"], man["segments_bytes"]
    if count == 0:
        return []
    p = os.path.join(root, _index_name(man))
    try:
        with open(p, "rb") as f:
            blob = f.read(nbytes)
    except OSError as e:
        raise CorruptSegmentError(f"segment index unreadable: {e}") from e
    if len(blob) < nbytes:
        raise CorruptSegmentError(
            f"segment index truncated: {len(blob)} < committed {nbytes}")
    lines = blob.decode().splitlines()
    if len(lines) != count:
        raise CorruptSegmentError(
            f"segment index has {len(lines)} committed lines, "
            f"manifest says {count}")
    try:
        return [SegmentMeta.from_json(json.loads(ln)) for ln in lines]
    except (json.JSONDecodeError, TypeError) as e:
        raise CorruptSegmentError(f"segment index corrupt: {e}") from e


def _append_segment_index(root: str, man: dict,
                          segs: Sequence[SegmentMeta]) -> int:
    """Append index lines after truncating any uncommitted tail; returns
    the new committed byte length."""
    p = os.path.join(root, _index_name(man))
    committed_bytes = man["segments_bytes"]
    data = "".join(json.dumps(s.to_json()) + "\n" for s in segs)
    with open(p, "ab") as f:
        f.truncate(committed_bytes)
        f.seek(committed_bytes)
        f.write(data.encode())
        f.flush()
        os.fsync(f.fileno())
    return committed_bytes + len(data.encode())


def _next_index_gen(old_man: dict | None) -> int:
    return (old_man.get("index_gen", 0) + 1) if old_man else 0


def _write_new_index_generation(root: str, gen: int,
                                segs: Sequence[SegmentMeta]) -> tuple[str, int]:
    """Write a fresh index generation (full rewrite / compaction) WITHOUT
    touching the committed one — the old manifest stays loadable until the
    new manifest commits. Returns (index name, byte length)."""
    name = SEGMENT_INDEX_NAME if gen == 0 else f"SEGMENTS.{gen}.jsonl"
    p = os.path.join(root, name)
    tmp = p + ".tmp"
    data = "".join(json.dumps(s.to_json()) + "\n" for s in segs)
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, p)
    _fsync_dir(root)
    return name, len(data.encode())


def _manifest_payload(store: "VersionedStore", saved_through: int, *,
                      segment_count: int, segments_bytes: int,
                      segment_index: str, index_gen: int,
                      segments_nbytes: int) -> dict:
    return {
        "format": FORMAT,
        "name": store.name,
        "schema": [dataclasses.asdict(f) for f in store.schema.values()],
        "n_rows": store.n_rows,
        "keys": [k.decode("latin1") for k in store.row_keys],
        "versions": [dataclasses.asdict(v) for v in store.versions],
        "saved_through_ts": int(saved_through),
        "segment_index": segment_index,
        "index_gen": index_gen,
        "segment_count": segment_count,
        "segments_bytes": segments_bytes,
        # running total of committed segment FILE bytes: keeps the
        # incremental-save stats O(new segments) instead of re-reading and
        # re-parsing the whole index just to sum nbytes
        "segments_nbytes": int(segments_nbytes),
        "history_digests": list(store._version_digests),
    }


def _compatible(man: dict, store: "VersionedStore", *,
                check_versions: bool = True) -> bool:
    """True when the on-disk manifest is a prefix of the in-memory store,
    i.e. appending segments (instead of rewriting) yields a correct store."""
    if man["name"] != store.name or man["n_rows"] > store.n_rows:
        return False
    for f in man["schema"]:
        fs = store.schema.get(f["name"])
        if fs is None or fs.width != f["width"] or fs.dtype != f["dtype"]:
            return False
    if [k.encode("latin1") for k in man["keys"]] != \
            store.row_keys[: len(man["keys"])]:
        return False
    if check_versions:
        # chained per-release CONTENT digests, not just version metadata:
        # two stores ingesting different data with identical churn shapes
        # still diverge here, so "same shape, different content" histories
        # can never be extended incrementally
        ours = store._version_digests
        theirs = man.get("history_digests", [])
        if (len(theirs) != len(man["versions"])
                or len(theirs) > len(ours)
                or ours[: len(theirs)] != theirs):
            return False
    return True


def _digest_prefix(man: dict, prior_digests: Sequence[str] | None) -> bool:
    """True when the manifest's content-digest chain is a prefix of
    ``prior_digests`` — i.e. the directory's history is an ancestor of the
    given chain, not a same-shaped divergent store's."""
    if prior_digests is None:
        return False
    theirs = man.get("history_digests", [])
    return (len(theirs) <= len(prior_digests)
            and list(prior_digests)[: len(theirs)] == list(theirs))


def _iter_logs(store: "VersionedStore"):
    """(field name, _CellLog, dtype, width) for every log incl. EXISTS."""
    for name, col in store.fields.items():
        yield name, col.log, col.schema.np_dtype, col.schema.width
    yield EXISTS_FIELD, store.exists_log, np.dtype(np.int8), 1


# -- save ---------------------------------------------------------------------

def save_store(store: "VersionedStore", path: str, *,
               force_full: bool = False) -> dict:
    """Segmented save: incremental when the manifest at ``path`` is a prefix
    of this store, full rewrite otherwise. See ``VersionedStore.save``."""
    os.makedirs(path, exist_ok=True)
    man = read_manifest(path)
    if not force_full and man is not None and _compatible(man, store):
        return _save_incremental(store, path, man)
    return _save_full(store, path, old_man=man)


def _seg_stats(segs: Sequence[SegmentMeta], raw: int, packed: int,
               mode: str, manifest_bytes: int, total_seg_bytes: int,
               index_bytes: int, index_written: int) -> dict:
    return {
        "mode": mode,
        "segments_written": len(segs),
        "bytes_written": (sum(s.nbytes for s in segs) + manifest_bytes
                          + index_written),
        "raw_bytes": raw,
        "packed_bytes": packed,
        "manifest_bytes": manifest_bytes,
        "disk_bytes": total_seg_bytes + manifest_bytes + index_bytes,
    }


def _save_incremental(store: "VersionedStore", path: str, man: dict) -> dict:
    cutoff = int(man["saved_through_ts"])
    new_segs: list[SegmentMeta] = []
    raw = packed = 0
    for name, log, dtype, width in _iter_logs(store):
        rows, tss, vals = log.cells_after(cutoff)
        if len(tss) == 0:
            continue
        seg, pbytes = write_segment(path, name, rows, tss, vals,
                                    device=log.device)
        new_segs.append(seg)
        raw += vals.nbytes
        packed += pbytes
    idx_bytes = _append_segment_index(path, man, new_segs)
    prior_bytes = man.get("segments_nbytes")
    if prior_bytes is None:  # manifest predates the running total
        prior_bytes = sum(s.nbytes for s in read_segment_index(path, man))
    total_seg_bytes = prior_bytes + sum(s.nbytes for s in new_segs)
    mb = write_manifest(path, _manifest_payload(
        store, max(cutoff, store.last_ts),
        segment_count=man["segment_count"] + len(new_segs),
        segments_bytes=idx_bytes, segment_index=_index_name(man),
        index_gen=man.get("index_gen", 0), segments_nbytes=total_seg_bytes))
    return _seg_stats(new_segs, raw, packed, "incremental", mb,
                      total_seg_bytes, idx_bytes,
                      idx_bytes - man["segments_bytes"])


def _save_full(store: "VersionedStore", path: str, *,
               old_man: dict | None) -> dict:
    # The new layout (segments + a NEW index generation) is written beside
    # the old one; the manifest replacement is the only commit point, so a
    # crash anywhere before it leaves the previous state loadable.
    old_segs: list[SegmentMeta] = []
    if old_man is not None:
        try:
            old_segs = read_segment_index(path, old_man)
        except CorruptSegmentError:
            pass  # rewriting anyway; orphans are cleaned best-effort below
    gen = _next_index_gen(old_man)
    segs: list[SegmentMeta] = []
    raw = packed = 0
    for name, log, dtype, width in _iter_logs(store):
        vals, tss, ptr = log.csr(store.n_rows)
        if len(tss) == 0:
            continue
        rows = np.repeat(np.arange(store.n_rows, dtype=np.int32),
                         np.diff(ptr))
        seg, pbytes = write_segment(path, name, rows, tss, vals, kind="base",
                                    tag=f".g{gen}" if gen else "",
                                    device=log.device)
        segs.append(seg)
        raw += vals.nbytes
        packed += pbytes
    idx_name, idx_bytes = _write_new_index_generation(path, gen, segs)
    total_seg_bytes = sum(s.nbytes for s in segs)
    mb = write_manifest(path, _manifest_payload(
        store, store.last_ts, segment_count=len(segs),
        segments_bytes=idx_bytes, segment_index=idx_name, index_gen=gen,
        segments_nbytes=total_seg_bytes))
    # only after the new layout is committed: drop files it doesn't own —
    # legacy monolithic snapshots, the superseded index generation, and
    # segments of the divergent old manifest
    for legacy in LEGACY_FILES:
        p = os.path.join(path, legacy)
        if os.path.exists(p):
            os.remove(p)
    if old_man is not None and _index_name(old_man) != idx_name:
        _remove_quiet(os.path.join(path, _index_name(old_man)))
    keep = {s.path for s in segs}
    for s in old_segs:
        if s.path not in keep:
            _remove_quiet(os.path.join(path, s.path))
    return _seg_stats(segs, raw, packed, "full", mb, total_seg_bytes,
                      idx_bytes, idx_bytes)


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


# -- load ---------------------------------------------------------------------

def _engine_schema(fields: list[dict]) -> list[dict]:
    """Narrow float64 schema entries to float32 on load: the 32-bit query
    engine always materialized float64 fields at float32 precision, so
    this preserves observable behavior while letting stores persisted
    before the wide-dtype rejection reopen (the next save migrates them to
    float32 on disk via the schema-mismatch full rewrite). int64 has no
    such lossless-in-practice narrowing and stays loudly rejected."""
    return [{**f, "dtype": "float32"} if f.get("dtype") == "float64" else f
            for f in fields]


def load_store(cls, path: str, *, lazy: bool = True,
               device=None) -> "VersionedStore":
    """Open a store directory on ``device``; see ``VersionedStore.load``."""
    from .store import FieldSchema, VersionInfo  # runtime import (cycle)
    man = read_manifest(path)
    if man is None:
        if os.path.exists(os.path.join(path, "meta.json")):
            return _load_legacy(cls, path, device=device)
        raise FileNotFoundError(f"no {MANIFEST_NAME} or legacy meta.json "
                                f"under {path}")
    st = cls(man["name"],
             [FieldSchema(**f) for f in _engine_schema(man["schema"])],
             capacity=max(16, man["n_rows"]), device=device)
    st.n_rows = man["n_rows"]
    st.row_keys = [k.encode("latin1") for k in man["keys"]]
    st.key_to_row = {k: i for i, k in enumerate(st.row_keys)}
    st.versions = [VersionInfo(**v) for v in man["versions"]]
    st._version_digests = list(man.get("history_digests", []))
    st._history_digest = (st._version_digests[-1]
                          if st._version_digests else "")
    by_field: dict[str, list[SegmentMeta]] = {}
    for seg in read_segment_index(path, man):
        check_segment_stat(path, seg)  # torn writes surface at open time
        by_field.setdefault(seg.field, []).append(seg)
    for name, log, dtype, width in _iter_logs(st):
        segs = sorted(by_field.pop(name, []), key=lambda s: s.ts0)
        log.attach_segments(
            [SegmentHandle(path, s, dtype, width) for s in segs])
    if by_field:
        raise CorruptSegmentError(
            f"manifest lists segments for unknown fields: {sorted(by_field)}")
    st.mark_heads_stale()
    if not lazy:
        st.rebuild_heads()
    st._invalidate_log()
    return st


# -- on-disk compaction -------------------------------------------------------

def compact_on_disk(store: "VersionedStore", path: str, before_ts: int, *,
                    prior_digests: Sequence[str] | None = None) -> dict:
    """Rewrite the store directory to mirror an in-memory ``compact``:
    per field one "base" segment (collapsed history at ``before_ts``), one
    optional "delta" gap segment (tail cells whose original segments
    straddled the compaction point or were never saved), and every existing
    segment entirely above ``before_ts`` retained untouched.

    Must run AFTER the in-memory compaction (``VersionedStore.compact``
    calls it in that order). Falls back to a full rewrite when the on-disk
    manifest does not belong to this store.

    Args:
      prior_digests: the store's PRE-compaction content-digest chain
        (in-memory compaction rechains the digests, so the post-compact
        store can no longer be compared against the manifest directly).
        The manifest's chain must be a prefix of it — otherwise the
        directory holds a divergent store's data and retaining its tail
        segments would silently splice foreign content; we full-rewrite
        instead. ``None`` (no provenance known) also forces a full rewrite.
    """
    man = read_manifest(path)
    if man is None or not _compatible(man, store, check_versions=False) \
            or not _digest_prefix(man, prior_digests):
        return save_store(store, path, force_full=True)
    retained: dict[str, list[SegmentMeta]] = {}
    covered: list[SegmentMeta] = []
    for seg in read_segment_index(path, man):
        if seg.ts0 > before_ts:
            retained.setdefault(seg.field, []).append(seg)
        else:
            covered.append(seg)
    gen = _next_index_gen(man)
    new_segs: list[SegmentMeta] = []
    raw = packed = 0
    for name, log, dtype, width in _iter_logs(store):
        vals, tss, ptr = log.csr(store.n_rows)  # fully in memory post-compact
        if len(tss) == 0:
            continue
        rows = np.repeat(np.arange(store.n_rows, dtype=np.int32),
                         np.diff(ptr))
        base = tss <= before_ts  # post-compact: exactly the collapsed base
        gap = ~base              # minus whatever retained segments cover
        for seg in retained.get(name, ()):
            gap &= ~((tss >= seg.ts0) & (tss <= seg.ts1))
        for mask, kind in ((base, "base"), (gap, "delta")):
            if mask.any():
                seg, pbytes = write_segment(path, name, rows[mask],
                                            tss[mask], vals[mask], kind=kind,
                                            tag=f".g{gen}",
                                            device=log.device)
                new_segs.append(seg)
                raw += vals[mask].nbytes
                packed += pbytes
    all_segs = new_segs + [s for segs in retained.values() for s in segs]
    # commit order mirrors _save_full: new index generation, then the
    # manifest swap, then deletion of superseded files
    idx_name, idx_bytes = _write_new_index_generation(path, gen, all_segs)
    total_seg_bytes = sum(s.nbytes for s in all_segs)
    mb = write_manifest(path, _manifest_payload(
        store, store.last_ts, segment_count=len(all_segs),
        segments_bytes=idx_bytes, segment_index=idx_name, index_gen=gen,
        segments_nbytes=total_seg_bytes))
    if _index_name(man) != idx_name:
        _remove_quiet(os.path.join(path, _index_name(man)))
    keep = {s.path for s in all_segs}
    for seg in covered:
        if seg.path not in keep:
            _remove_quiet(os.path.join(path, seg.path))
    stats = _seg_stats(new_segs, raw, packed, "compact", mb, total_seg_bytes,
                       idx_bytes, idx_bytes)
    stats["segments_retained"] = len(all_segs) - len(new_segs)
    stats["segments_dropped"] = len(covered)
    return stats


# -- legacy monolithic snapshots (pre-segment format) -------------------------

def write_legacy_snapshot(store: "VersionedStore", path: str) -> dict:
    """Write the pre-segment monolithic ``cells.npz`` + ``meta.json``
    snapshot. Kept for migration tests; new code should use
    ``save_store``.
    """
    os.makedirs(path, exist_ok=True)
    meta = {
        "name": store.name,
        "schema": [dataclasses.asdict(f) for f in store.schema.values()],
        "n_rows": store.n_rows,
        "keys": [k.decode("latin1") for k in store.row_keys],
        "versions": [dataclasses.asdict(v) for v in store.versions],
    }
    arrays: dict[str, np.ndarray] = {}
    stats = {"raw_bytes": 0, "packed_bytes": 0}
    for name, col in store.fields.items():
        vals, tss, ptr = col.log.csr(store.n_rows)
        rows = np.repeat(np.arange(store.n_rows, dtype=np.int32),
                         np.diff(ptr))
        packed, pmeta = chain_pack(vals, rows, device=store.device)
        arrays[f"f:{name}:vals"] = packed
        arrays[f"f:{name}:ts"] = tss
        arrays[f"f:{name}:ptr"] = ptr
        meta.setdefault("pack", {})[name] = pmeta
        stats["raw_bytes"] += vals.nbytes
        stats["packed_bytes"] += packed.nbytes
    ev, ets, eptr = store.exists_log.csr(store.n_rows)
    arrays["exists:vals"], arrays["exists:ts"], arrays["exists:ptr"] = \
        ev, ets, eptr
    np.savez_compressed(os.path.join(path, "cells.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    stats["disk_bytes"] = os.path.getsize(os.path.join(path, "cells.npz"))
    stats["bytes_written"] = stats["disk_bytes"] + \
        os.path.getsize(os.path.join(path, "meta.json"))
    stats["mode"] = "legacy-full"
    return stats


def _load_legacy(cls, path: str, *, device=None) -> "VersionedStore":
    """Load a pre-segment monolithic snapshot (eager: inflates everything,
    which is exactly why the segmented layout replaced it)."""
    from .store import FieldSchema, VersionInfo
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "cells.npz"))
    st = cls(meta["name"],
             [FieldSchema(**f) for f in _engine_schema(meta["schema"])],
             capacity=max(16, meta["n_rows"]), device=device)
    st.n_rows = meta["n_rows"]
    st.row_keys = [k.encode("latin1") for k in meta["keys"]]
    st.key_to_row = {k: i for i, k in enumerate(st.row_keys)}
    st.versions = [VersionInfo(**v) for v in meta["versions"]]
    for name, col in st.fields.items():
        ptr = data[f"f:{name}:ptr"]
        rows = np.repeat(np.arange(st.n_rows, dtype=np.int32), np.diff(ptr))
        vals = chain_unpack(data[f"f:{name}:vals"], rows,
                            meta["pack"][name], col.schema.np_dtype)
        col.log.splice_csr(vals.reshape(len(rows), col.schema.width),
                           data[f"f:{name}:ts"], rows, ptr, st.n_rows)
    eptr = data["exists:ptr"]
    erows = np.repeat(np.arange(st.n_rows, dtype=np.int32), np.diff(eptr))
    st.exists_log.splice_csr(data["exists:vals"], data["exists:ts"], erows,
                             eptr, st.n_rows)
    # legacy snapshots carry no content digests; seed a deterministic
    # chain so the store saves (full rewrite) and evolves consistently
    st._rechain_digests("legacy")
    st.mark_heads_stale()
    st.rebuild_heads()
    st._invalidate_log()
    return st
