"""Streaming ingest engine: chunked parse -> shard-parallel update waves.

The paper's dominant workload is swallowing each new multi-GB database
release (Tables 1/3 are update-bound), and the pre-existing path held the
whole release — text, keys, and stacked value blocks — in host memory
before a single serial scatter. This engine makes ingest a bounded-memory
pipeline instead:

  stage 1  reader      release text streamed in ``chunk_chars`` pieces
                       (a path, a callable, or any str-chunk iterable)
  stage 2  parse       the streaming entry splitter (plugins.py) cuts
                       records at arbitrary chunk boundaries; entries are
                       split into ``batch_entries``-row batches, optionally
                       fanned over a parse worker pool
  stage 3  queue       a ``queue_depth``-bounded handoff — the memory
                       ceiling, and the overlap point: batch k+1 parses
                       while batch k applies
  stage 4  journal     each batch is journaled (ft/checkpoint.py
                       ``IngestJournal``) before it mutates the store, so
                       a crash mid-release replays parsed chunks instead
                       of re-parsing the file
  stage 5  apply       ``begin_release`` session: the batch is routed by
                       the ``shard_route`` kernel and applied to all
                       shards as one concurrent wave (core/shard.py)

One release timestamp commits atomically at ``finish()``; the journal is
the only mid-release durability (see ``IngestJournal`` for why the
store's own incremental save cannot checkpoint half a release).

Backpressure: when the serving tier's ``TieredStorePool.pressure()``
(or any ``pressure_fn``) exceeds ``max_pressure``, the apply loop waits —
ingest yields to query traffic instead of thrashing the pool.

``synth_uniprot_chunks`` generates arbitrarily large synthetic UniProtKB
releases as a stream (never materialized), for benchmarks and tests.

The port's copy of ``repro.core.ingest``. Waves run on the store's
device: on a card each wave's fingerprints (and, sharded, its key route)
launch from the session's threads.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np

from ..obs import RECORDER, REGISTRY, get_logger, span

from .plugins import FileParser
from .store import VersionInfo

_LOG = get_logger("ingest")

#: str path | iterable of text chunks | callable(start_offset) -> iterable
Source = "str | Iterable[str] | Callable[[int], Iterable[str]]"


class IngestResumeError(RuntimeError):
    """A journal exists for this release but the store does not match its
    pre-release watermark — the store moved on (or holds a half-applied
    release in memory). Reload the store from its directory, or clear the
    journal to start over."""


@dataclasses.dataclass
class IngestConfig:
    """Streaming-ingest tuning knobs (defaults suit multi-MB releases)."""
    chunk_chars: int = 1 << 20     #: source read size (chars == bytes, ASCII)
    batch_entries: int = 1024      #: entries per parsed batch (= one wave)
    #: bounded parse->apply queue (memory cap); 0 runs stage 2 inline —
    #: also the automatic mode on single-CPU hosts, where a reader thread
    #: buys no overlap, only switch overhead
    queue_depth: int = 4
    parse_workers: int = 0         #: >0: split entries on a thread pool
    manifest_every: int = 1        #: journal-manifest commit cadence (batches)
    max_pressure: float | None = None   #: backpressure threshold
    pressure_poll_s: float = 0.01       #: backpressure poll interval
    max_backpressure_wait_s: float = 30.0  #: liveness cap per wait


@dataclasses.dataclass
class IngestReport:
    """What one ``ingest_release`` call did (see field comments)."""
    ts: int
    label: str
    n_entries: int = 0             #: total entries applied this run
    n_chunks: int = 0              #: batches applied (replayed + parsed)
    chunks_replayed: int = 0       #: batches replayed from the journal
    entries_replayed: int = 0
    entries_parsed: int = 0        #: entries parsed from the source this run
    checkpoint_writes: int = 0
    backpressure_waits: int = 0
    backpressure_wait_s: float = 0.0
    wall_s: float = 0.0
    already_committed: bool = False  #: crash landed after finish(); no-op
    info: VersionInfo | None = None

    @property
    def entries_per_s(self) -> float:
        return self.n_entries / self.wall_s if self.wall_s > 0 else 0.0


# -- source plumbing ---------------------------------------------------------
def read_file_chunks(path: str, chunk_chars: int = 1 << 20,
                     start: int = 0) -> Iterator[str]:
    """Stream a release file as text chunks. Bytes decode latin-1 so one
    char is one byte — journal source offsets are therefore byte offsets
    and a resume can ``seek`` (release flat files are ASCII; non-ASCII
    bytes survive the round trip but keys derived from them would be
    mojibake-encoded)."""
    with open(path, "rb") as f:
        if start:
            f.seek(start)
        while True:
            b = f.read(chunk_chars)
            if not b:
                return
            yield b.decode("latin-1")


def _open_source(source, start: int, chunk_chars: int) -> Iterable[str]:
    if isinstance(source, str):
        return read_file_chunks(source, chunk_chars, start)
    if callable(source):
        return source(start)
    if start:
        raise ValueError(
            "iterable sources cannot seek to a resume offset; pass a file "
            "path or a callable(start) -> chunks")
    return iter(source)


def _seekable(source) -> bool:
    return isinstance(source, str) or callable(source)


# -- store watermark ---------------------------------------------------------
def store_watermark(store) -> dict:
    """Fingerprint of a store's committed state, cheap and stable across
    save/lazy-load cycles: last committed ts, total cell count (resident
    + pending segments), and the content digest chain head (per shard for
    a sharded store). The ingest journal pins this at session start; a
    resume refuses any store whose watermark moved."""
    from .shard import ShardedStore
    if isinstance(store, ShardedStore):
        shards = [store.shard(i) for i in range(store.n_shards)]
        return {"last_ts": int(store.last_ts),
                "digests": [sh._history_digest for sh in shards],
                "n_cells": sum(_n_cells(sh) for sh in shards)}
    return {"last_ts": int(store.last_ts),
            "digests": [store._history_digest],
            "n_cells": _n_cells(store)}


def _n_cells(vs) -> int:
    return (vs.exists_log.n_cells
            + sum(col.log.n_cells for col in vs.fields.values()))


# -- parse pipeline ----------------------------------------------------------
def _cpu_count() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


class _BatchAssembler:
    """Accumulates parsed rows straight into preallocated schema-shaped
    arrays — the bounded-memory replacement for the list-of-row-dicts +
    ``stack_rows`` pass of ``parse_text``. Strict about dtypes: rows must
    arrive in the parser's declared dtype (true of every shipped parser;
    the whole-file path would have value-checked the cast instead)."""

    def __init__(self, parser: FileParser, cap: int):
        self._schema = parser.schema()
        self._cap = cap
        self.keys: list[bytes] = []
        self._arrays: dict[str, np.ndarray] | None = None

    def add(self, key: bytes, row: dict) -> bool:
        """Append one record; True when the batch is full."""
        if self._arrays is None:
            self._arrays = {fs.name: np.empty((self._cap, fs.width),
                                              fs.np_dtype)
                            for fs in self._schema}
        i = len(self.keys)
        for name, v in row.items():
            dst = self._arrays.get(name)
            if dst is None or np.asarray(v).dtype != dst.dtype:
                raise TypeError(
                    f"parser emitted field {name!r} outside its declared "
                    "schema dtype — streaming ingest requires rows in the "
                    "exact schema() dtypes")
            dst[i] = v
        self.keys.append(key)
        return len(self.keys) >= self._cap

    def flush(self) -> tuple[list[bytes], dict[str, np.ndarray]]:
        n = len(self.keys)
        keys = self.keys
        table = {name: a[:n] for name, a in (self._arrays or {}).items()}
        self.keys, self._arrays = [], None
        return keys, table


def _split_batch(parser: FileParser, texts: list[str], offs: list):
    asm = _BatchAssembler(parser, len(texts))
    for t in texts:
        k, r = parser.split_entry(t)
        asm.add(k, r)
    keys, table = asm.flush()
    return keys, table, offs[-1] if offs else None


def _batches(parser: FileParser, chunks: Iterable[str], cfg: IngestConfig,
             entry_mode: bool, skip_records: int,
             pool: ThreadPoolExecutor | None):
    """Stage 2: split the chunk stream into ``(payload, end_offset, n)``
    batches, where payload is ``(keys, table)`` — or a Future of
    ``(keys, table, off)`` when a parse worker pool fans out the entry
    splitting."""
    if entry_mode and pool is not None:
        texts: list[str] = []
        offs: list = []
        for entry, off in parser.iter_entries_with_offsets(chunks):
            texts.append(entry)
            offs.append(off)
            if len(texts) >= cfg.batch_entries:
                yield pool.submit(_split_batch, parser, texts, offs), \
                    offs[-1], len(texts)
                texts, offs = [], []
        if texts:
            yield (pool.submit(_split_batch, parser, texts, offs),
                   offs[-1], len(texts))
        return
    asm = _BatchAssembler(parser, cfg.batch_entries)
    if entry_mode:
        last_off = None
        for entry, off in parser.iter_entries_with_offsets(chunks):
            k, r = parser.split_entry(entry)
            last_off = off
            if asm.add(k, r):
                keys, table = asm.flush()
                yield (keys, table), last_off, len(keys)
    else:
        # block formats (stateful iter_records override): sequential
        # record machine, resume by skipping already-applied records
        seen = 0
        for k, r in parser.iter_records(chunks):
            seen += 1
            if seen <= skip_records:
                continue
            if asm.add(k, r):
                keys, table = asm.flush()
                yield (keys, table), None, len(keys)
        last_off = None
    if asm.keys:
        keys, table = asm.flush()
        yield (keys, table), last_off, len(keys)


def _bounded_put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put that cannot deadlock against a dead consumer."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _producer(gen, q: queue.Queue, stop: threading.Event) -> None:
    """Pipelined stage-2 wrapper: drain the batch generator into the
    bounded queue from a reader thread. Items: ("batch", payload, off, n),
    then ("done"|"error", payload, None, 0)."""
    try:
        for payload, off, n in gen:
            if not _bounded_put(q, ("batch", payload, off, n), stop):
                return
        _bounded_put(q, ("done", None, None, 0), stop)
    except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
        _bounded_put(q, ("error", e, None, 0), stop)


# -- the engine --------------------------------------------------------------
def ingest_release(store, source, parser: FileParser, ts: int, *,
                   label: str = "", full_release: bool = True,
                   config: IngestConfig | None = None,
                   journal_dir: str | None = None,
                   store_dir: str | None = None,
                   pressure_fn: Callable[[], float] | None = None,
                   on_batch: Callable[[int, int, bool], None] | None = None,
                   ) -> IngestReport:
    """Stream one release into ``store`` (either flavor) at ``ts``.

    Args:
      store: ``VersionedStore`` or ``ShardedStore`` (wave-parallel).
      source: file path (resumable via seek), str-chunk iterable, or
        ``callable(start_offset) -> chunk iterable``.
      parser: the release's ``FileParser``; its schema is pre-declared on
        the store so chunk-local inference never narrows dtypes.
      ts / label / full_release: as ``VersionedStore.update``.
      config: pipeline knobs (``IngestConfig``).
      journal_dir: enables crash-resume — parsed batches journal here
        before applying. Call again with the SAME arguments after a crash
        (store reloaded from ``store_dir``): journaled chunks replay
        without re-parsing, the source resumes at the journaled offset,
        and the finished store is byte-identical to an uninterrupted run.
      store_dir: the store's directory. Saved (incrementally) before the
        first chunk so disk holds the exact pre-release state a resume
        reloads, and again after ``finish()`` — release cells reach disk
        exactly once. The journal is cleared only after that final save.
      pressure_fn: mutation backpressure (e.g. ``pool.pressure``); waves
        wait while it exceeds ``config.max_pressure``.
      on_batch: ``(batch_idx, n_entries, replayed)`` test/progress hook,
        called after each applied batch.

    Returns:
      IngestReport (``already_committed=True`` when a resume found the
      release already finished — crash landed between the final save and
      journal cleanup).

    Raises:
      IngestResumeError: journal/store watermark mismatch.
      ValueError: non-monotonic ``ts`` or a mid-stream validation failure
        (already-applied chunks stay applied; the journal resumes them).
    """
    from ..ft.checkpoint import IngestJournal

    cfg = config or IngestConfig()
    rep = IngestReport(ts=int(ts), label=label or str(ts))
    t_run = time.perf_counter()
    entry_mode = type(parser).iter_records is FileParser.iter_records
    track_offsets = entry_mode and _seekable(source)

    journal = None
    replay: list[dict] = []
    start_offset = 0
    skip_records = 0
    if journal_dir is not None:
        j = IngestJournal.open(journal_dir)
        if (j is not None and j.meta["ts"] == int(ts)
                and j.meta["store"] == store.name):
            if store.last_ts >= int(ts):
                # the crash landed after finish(): release committed,
                # journal just never got cleaned up
                j.clear()
                rep.already_committed = True
                rep.wall_s = time.perf_counter() - t_run
                return rep
            wm = store_watermark(store)
            if wm != j.meta["watermark"]:
                raise IngestResumeError(
                    f"ingest journal {journal_dir} was written against a "
                    f"different store state (journal {j.meta['watermark']} "
                    f"vs store {wm}); reload the store from its directory "
                    "or clear the journal")
            journal = j
            replay = list(j.chunks)
            off = j.resume_offset()
            if off is None or not track_offsets:
                skip_records = j.entries_applied()
                start_offset = 0
            else:
                start_offset = off
            _LOG.info("ingest resume: %d journaled chunks, offset %s",
                      len(replay), off)
        else:
            if j is not None:
                j.clear()  # stale journal for some other release
            if store_dir is not None:
                store.save(store_dir)  # durable pre-release state
            journal = IngestJournal.begin(
                journal_dir, store=store.name, ts=int(ts), label=label,
                full_release=full_release, watermark=store_watermark(store))

    # pre-declare the parser schema: chunk-local inference must never get
    # to pick a narrower dtype than the whole file would
    for fs in parser.schema():
        if fs.name not in store.fields:
            store.add_field(fs)

    c_chunks = REGISTRY.counter("ingest.chunks_parsed")
    c_entries = REGISTRY.counter("ingest.entries_routed")
    c_ckpt = REGISTRY.counter("ingest.checkpoint_writes")
    c_bp = REGISTRY.counter("ingest.backpressure_waits")
    h_wave = REGISTRY.histogram("ingest.wave_wall")

    def wait_pressure() -> None:
        if pressure_fn is None or cfg.max_pressure is None:
            return
        waited = 0.0
        while (pressure_fn() > cfg.max_pressure
               and waited < cfg.max_backpressure_wait_s):
            if waited == 0.0:
                c_bp.inc()
                rep.backpressure_waits += 1
            time.sleep(cfg.pressure_poll_s)
            waited += cfg.pressure_poll_s
        rep.backpressure_wait_s += waited

    session = store.begin_release(int(ts), label=label,
                                  full_release=full_release)
    with span("ingest", store=store.name, ts=int(ts)) as sp:
        try:
            # -- replay journaled chunks (no re-parse) ----------------------
            for c in replay:
                keys, table = journal.load_chunk(c["idx"])
                wait_pressure()
                t0 = time.perf_counter()
                session.apply(keys, table)
                h_wave.record(time.perf_counter() - t0)
                c_entries.inc(len(keys))
                rep.n_chunks += 1
                rep.chunks_replayed += 1
                rep.n_entries += len(keys)
                rep.entries_replayed += len(keys)
                if on_batch is not None:
                    on_batch(rep.n_chunks - 1, len(keys), True)

            # -- parse + apply the remaining source, pipelined --------------
            chunks = _open_source(source, start_offset, cfg.chunk_chars)
            pool = (ThreadPoolExecutor(
                max_workers=cfg.parse_workers,
                thread_name_prefix="ingest-parse")
                if cfg.parse_workers > 0 and entry_mode else None)
            gen = _batches(parser, chunks, cfg, entry_mode, skip_records,
                           pool)

            def apply_batch(payload, off) -> None:
                if isinstance(payload, Future):
                    keys, table, off = payload.result()
                else:
                    keys, table = payload
                wait_pressure()
                if journal is not None:
                    journal.record_chunk(
                        keys, table, source_offset=off,
                        flush=(rep.n_chunks % cfg.manifest_every == 0))
                    c_ckpt.inc()
                    rep.checkpoint_writes += 1
                t0 = time.perf_counter()
                session.apply(keys, table)
                h_wave.record(time.perf_counter() - t0)
                c_chunks.inc()
                c_entries.inc(len(keys))
                rep.n_chunks += 1
                rep.n_entries += len(keys)
                rep.entries_parsed += len(keys)
                if on_batch is not None:
                    on_batch(rep.n_chunks - 1, len(keys), False)

            try:
                if cfg.queue_depth > 0 and _cpu_count() > 1:
                    q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
                    stop = threading.Event()
                    prod = threading.Thread(
                        target=_producer, args=(gen, q, stop),
                        name="ingest-reader", daemon=True)
                    prod.start()
                    try:
                        while True:
                            kind, payload, off, _n = q.get()
                            if kind == "done":
                                break
                            if kind == "error":
                                raise payload
                            apply_batch(payload, off)
                    finally:
                        stop.set()
                        prod.join(timeout=5.0)
                else:
                    # inline mode: no reader thread to overlap with
                    for payload, off, _n in gen:
                        apply_batch(payload, off)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
            if journal is not None:
                journal.flush()
            rep.info = session.finish()
        except BaseException as e:  # noqa: BLE001 — abort telemetry, re-raise
            RECORDER.record("ingest_abort", trace=sp.trace_id,
                            store=store.name, ts=int(ts),
                            chunks_applied=rep.n_chunks,
                            entries_applied=rep.n_entries, error=repr(e))
            raise

    if store_dir is not None:
        store.save(store_dir)  # release cells reach disk exactly once
        if journal is not None:
            journal.clear()  # durable => the journal has served its purpose
    rep.wall_s = time.perf_counter() - t_run
    return rep


# -- synthetic UniProtKB releases --------------------------------------------
_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def synth_uniprot_chunks(n_entries: int, *, seed: int = 0,
                         churn: float = 0.0, seq_len: int = 180,
                         entries_per_chunk: int = 64) -> Iterator[str]:
    """Generate a synthetic UniProtKB ``.dat`` release as a text stream.

    Deterministic in ``seed``; ``churn`` perturbs that fraction of
    entries' sequences (vary it across releases to model real release
    deltas). The stream yields ``entries_per_chunk`` entries per chunk and
    never materializes the release — generating a 10M-entry release costs
    O(chunk) memory. Keys are ``P<i:08d>`` accessions, entries carry the
    ID/AC/DE/OX/SQ lines ``UniProtParser`` reads.

    The JAX package's text, byte for byte, from the same draws made in
    bulk: a chunk's churn draws at once (the same stream as one draw an
    entry), one reseeded generator for every entry's own draws, and a
    sequence as one table lookup.
    """
    rng = np.random.RandomState(seed)
    erng = np.random.RandomState()
    step = max(entries_per_chunk, 1)
    for c0 in range(0, n_entries, step):
        ids = range(c0, min(c0 + step, n_entries))
        mutate = (rng.random_sample(len(ids)) < churn if churn > 0
                  else np.zeros(len(ids), bool))
        out: list[str] = []
        for i, m in zip(ids, mutate):
            erng.seed((i * 2654435761 + (seed + 1 if m else 0)) % (2**31))
            seq = _AA[erng.randint(0, len(_AA), seq_len)].tobytes().decode()
            taxid = int(erng.randint(1, 99999))
            out.append(
                f"ID   E{i:08d}_SYN        Reviewed;       {seq_len} AA.\n"
                f"AC   P{i:08d};\n"
                f"DE   RecName: Full=Synthetic protein {i};\n"
                f"OS   Synthetica gestorensis.\n"
                f"OX   NCBI_TaxID={taxid};\n"
                f"SQ   SEQUENCE   {seq_len} AA;  00000 MW;  0000000000000000 CRC64;\n"
                + "".join(f"     {seq[j:j + 60]}\n"
                          for j in range(0, seq_len, 60))
                + "//\n")
        yield "".join(out)


def write_synth_uniprot(path: str, n_entries: int, *, seed: int = 0,
                        churn: float = 0.0, seq_len: int = 180) -> int:
    """Stream a synthetic release to ``path``; returns its byte size."""
    n = 0
    with open(path, "w") as f:
        for chunk in synth_uniprot_chunks(n_entries, seed=seed, churn=churn,
                                          seq_len=seq_len):
            f.write(chunk)
            n += len(chunk)
    return n
