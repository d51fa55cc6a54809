"""The port's streaming ingest (``repro_torch.core.ingest``, its journal
``repro_torch.ft.checkpoint.IngestJournal``, ``GeStore.add_release_stream``
and ``WorkflowManager.ingest_release``) against the JAX package, on the
CPU.

The cases of ``tests/test_ingest.py`` stream releases into the port's
stores (``device="cpu"``); the JAX package parses the same release whole
and updates its own store, and the history digests must be equal. The
kill-and-resume case also holds the port's journal files (manifest and
chunk ``.npz``) against a journal the JAX package's ``IngestJournal``
writes from its own parser's batches, and the finished store directory
against the JAX store's, byte for byte. ``store_watermark`` of a lazily
reopened port store equals the JAX package's of the same directory.
"""
import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.ingest as jingest  # noqa: E402
import repro.core.shard as jshard  # noqa: E402
import repro.core.store as jstore  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.core.parsers.uniprot import UniProtParser as JUniProt  # noqa: E402
from repro.ft.checkpoint import IngestJournal as JJournal  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.core.ingest import (IngestConfig, IngestResumeError,  # noqa: E402
                                     ingest_release, read_file_chunks,
                                     store_watermark, synth_uniprot_chunks,
                                     write_synth_uniprot)
from repro_torch.core.parsers.uniprot import UniProtParser  # noqa: E402
from repro_torch.core.shard import ShardedStore  # noqa: E402
from repro_torch.core.store import VersionedStore  # noqa: E402
from repro_torch.ft.checkpoint import IngestJournal  # noqa: E402
from repro_torch.obs import RECORDER, REGISTRY  # noqa: E402

# UniProt's schema at narrower rows (the facade's 512 / 256 run on the
# card in chip_smoke.py): the JAX package compiles its store per width
P = UniProtParser(seq_width=64, annot_width=32)
JP = JUniProt(seq_width=64, annot_width=32)
N = 260


def _digests(st):
    if hasattr(st, "n_shards"):
        return [st.shard(i)._history_digest for i in range(st.n_shards)]
    return [st._history_digest]


def _sharded(capacity=128):
    return ShardedStore("ing", P.schema(), n_shards=4, capacity=capacity,
                        device="cpu")


def _jsharded(capacity=128):
    return jshard.ShardedStore("ing", JP.schema(), n_shards=4,
                               capacity=capacity)


def _release_file(tmp_path, n=N, seed=5, churn=0.0):
    path = os.path.join(str(tmp_path), f"rel_{seed}_{churn}.dat")
    size = write_synth_uniprot(path, n, seed=seed, churn=churn)
    want = jingest.synth_uniprot_chunks(n, seed=seed, churn=churn)
    with open(path) as f:
        assert f.read() == "".join(want) and size == os.path.getsize(path)
    return path


def _reference(path, st, ts=1, label="r"):
    """The JAX package's answer: the whole file parsed by its parser into
    its store (``st``, a JAX-package store)."""
    with open(path, encoding="latin-1") as f:
        keys, table = JP.parse_text(f.read())
    st.update(ts, keys, table, label=label)
    return st


def _tree(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = f.read()
    return out


@pytest.mark.parametrize("cfg", [
    IngestConfig(chunk_chars=509, batch_entries=48),
    IngestConfig(chunk_chars=1 << 20, batch_entries=64, queue_depth=0),
    IngestConfig(chunk_chars=4096, batch_entries=32, parse_workers=2)],
    ids=["small-chunks", "inline", "parse-workers"])
def test_stream_matches_wholefile_sharded(tmp_path, cfg):
    path = _release_file(tmp_path)
    ref = _reference(path, _jsharded())
    st = _sharded()
    rep = ingest_release(st, path, P, 1, label="r", config=cfg)
    assert rep.n_entries == N and rep.entries_parsed == N
    assert _digests(st) == _digests(ref)


def test_stream_matches_wholefile_unsharded(tmp_path):
    path = _release_file(tmp_path)
    ref = _reference(path, jstore.VersionedStore("ing", JP.schema(),
                                                 capacity=512))
    st = VersionedStore("ing", P.schema(), capacity=512, device="cpu")
    ingest_release(st, path, P, 1, label="r",
                   config=IngestConfig(chunk_chars=777, batch_entries=50))
    assert _digests(st) == _digests(ref)
    assert store_watermark(st) == jingest.store_watermark(ref)


def test_stream_second_release_churn(tmp_path):
    p1 = _release_file(tmp_path, seed=5)
    p2 = _release_file(tmp_path, seed=5, churn=0.3)
    ref = _reference(p2, _reference(p1, _jsharded()), ts=2, label="r2")
    st = _sharded()
    cfg = IngestConfig(chunk_chars=2048, batch_entries=64)
    ingest_release(st, p1, P, 1, label="r", config=cfg)
    rep = ingest_release(st, p2, P, 2, label="r2", config=cfg)
    assert _digests(st) == _digests(ref)
    want = ref.versions[-1]
    assert (rep.info.n_new, rep.info.n_updated, rep.info.n_deleted) == \
        (want.n_new, want.n_updated, want.n_deleted)


def test_stream_iterable_source():
    chunks = list(synth_uniprot_chunks(N, seed=7))
    assert chunks == list(jingest.synth_uniprot_chunks(N, seed=7))
    ref = _jsharded()
    keys, table = JP.parse_text("".join(chunks))
    ref.update(1, keys, table, label="r")
    st = _sharded()
    ingest_release(st, iter(chunks), P, 1, label="r",
                   config=IngestConfig(batch_entries=40))
    assert _digests(st) == _digests(ref)
    from repro_torch.core.ingest import _open_source
    with pytest.raises(ValueError, match="cannot seek"):
        _open_source(iter(chunks), 5, 10)  # an iterable cannot resume


@pytest.mark.parametrize("kw", [
    dict(n_entries=300, seed=3), dict(n_entries=300, seed=3, churn=0.03),
    dict(n_entries=301, seed=9, churn=0.5, seq_len=61, entries_per_chunk=7),
    dict(n_entries=0), dict(n_entries=5, churn=0.9, seq_len=0,
                            entries_per_chunk=0),
    dict(n_entries=40, seq_len=120, churn=1.0, entries_per_chunk=1)],
    ids=["plain", "churn", "ragged", "empty", "chunk0", "all-churn"])
def test_synth_release_matches_jax(tmp_path, kw):
    """The port's synthetic release (its draws made in bulk) is the JAX
    package's text chunk for chunk, and so is the file written from it."""
    assert list(synth_uniprot_chunks(**kw)) == \
        list(jingest.synth_uniprot_chunks(**kw))
    n = kw.pop("n_entries")
    kw.pop("entries_per_chunk", None)
    paths = [str(tmp_path / f"{w}.dat") for w in "jt"]
    sizes = (jingest.write_synth_uniprot(paths[0], n, **kw),
             write_synth_uniprot(paths[1], n, **kw))
    assert sizes[0] == sizes[1]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


class _Kill(Exception):
    pass


def _killer_at(k):
    def hook(idx, n_entries, replayed):
        if idx == k:
            raise _Kill
    return hook


def _jax_journal(root, path, cfg, n_chunks, watermark):
    """The journal the JAX package writes for the first ``n_chunks``
    batches of ``path``: its parser's batches and entry offsets through
    its own ``IngestJournal``."""
    j = JJournal.begin(root, store="ing", ts=1, label="r",
                       full_release=True, watermark=watermark)
    keys, rows, offs = [], [], []
    for entry, off in JP.iter_entries_with_offsets(
            jingest.read_file_chunks(path, cfg.chunk_chars)):
        k, r = JP.split_entry(entry)
        keys.append(k)
        rows.append(r)
        offs.append(off)
        if len(keys) == cfg.batch_entries:
            j.record_chunk(keys, JP.stack_rows(rows), source_offset=offs[-1],
                           flush=(len(j.chunks) % cfg.manifest_every == 0))
            keys, rows, offs = [], [], []
            if len(j.chunks) == n_chunks:
                return j


def test_resume_replays_only_remaining_chunks(tmp_path):
    """Kill at chunk k, reload from disk, resume: journaled chunks replay,
    only the tail is parsed, and the store equals the JAX package's. The
    journal at the kill is the JAX package's journal byte for byte, and
    the finished directory the JAX store's saved the same way."""
    path = _release_file(tmp_path)
    sdir = os.path.join(str(tmp_path), "store")
    jdir = os.path.join(str(tmp_path), "journal")
    cfg = IngestConfig(chunk_chars=1 << 20, batch_entries=32)

    st = _sharded()
    st.save(sdir)
    kill_at = 3
    with pytest.raises(_Kill):
        ingest_release(st, path, P, 1, label="r", config=cfg,
                       journal_dir=jdir, store_dir=sdir,
                       on_batch=_killer_at(kill_at))
    ref_dir = os.path.join(str(tmp_path), "jstore")
    ref = _jsharded()
    ref.save(ref_dir)
    jj = os.path.join(str(tmp_path), "jjournal")
    _jax_journal(jj, path, cfg, kill_at + 1, jingest.store_watermark(ref))
    assert _tree(jdir) == _tree(jj)
    assert len(IngestJournal.open(jdir).chunks) == kill_at + 1

    st2 = ShardedStore.load(sdir, device="cpu")
    rep = ingest_release(st2, path, P, 1, label="r", config=cfg,
                         journal_dir=jdir, store_dir=sdir)
    assert rep.chunks_replayed == kill_at + 1
    assert rep.entries_replayed == (kill_at + 1) * cfg.batch_entries
    assert rep.entries_parsed == N - rep.entries_replayed
    assert rep.n_entries == N
    _reference(path, ref)
    ref.save(ref_dir)
    assert _digests(st2) == _digests(ref)
    assert not os.path.exists(os.path.join(jdir, "JOURNAL.json"))
    assert _tree(sdir) == _tree(ref_dir)
    assert _digests(ShardedStore.load(sdir, device="cpu")) == _digests(ref)


def test_watermark_of_lazy_reopen_matches_jax(tmp_path):
    """``store_watermark`` counts cells of segments not yet loaded: a
    lazily reopened port store gives the JAX package's watermark of the
    same directory, sharded and not, before and after a query loads
    segments."""
    p1 = _release_file(tmp_path, n=90, seed=9)
    p2 = _release_file(tmp_path, n=90, seed=9, churn=0.5)
    for sharded in (True, False):
        sdir = os.path.join(str(tmp_path), f"wm_{sharded}")
        st = (_sharded() if sharded else
              VersionedStore("ing", P.schema(), device="cpu"))
        for ts, p in ((1, p1), (2, p2)):
            ingest_release(st, p, P, ts, config=IngestConfig(
                batch_entries=45), store_dir=sdir, journal_dir=os.path.join(
                str(tmp_path), f"j_{sharded}"))
        lazy = tcore.open_any_store(sdir, lazy=True, device="cpu")
        jlazy = jshard.open_any_store(sdir, lazy=True)
        want = jingest.store_watermark(jlazy)
        assert store_watermark(lazy) == want == store_watermark(st)
        assert want["n_cells"] > 0
        lazy.get_versions([1])
        assert store_watermark(lazy) == want


def test_resume_already_committed(tmp_path, monkeypatch):
    path = _release_file(tmp_path)
    sdir = os.path.join(str(tmp_path), "store")
    jdir = os.path.join(str(tmp_path), "journal")
    st = _sharded()
    st.save(sdir)
    monkeypatch.setattr(IngestJournal, "clear", lambda self: None)
    cfg = IngestConfig(batch_entries=64)
    ingest_release(st, path, P, 1, label="r", config=cfg,
                   journal_dir=jdir, store_dir=sdir)
    monkeypatch.undo()
    before = _digests(st)
    assert before == _digests(_reference(path, _jsharded()))
    st2 = ShardedStore.load(sdir, device="cpu")
    rep = ingest_release(st2, path, P, 1, label="r", config=cfg,
                         journal_dir=jdir, store_dir=sdir)
    assert rep.already_committed and rep.n_entries == 0
    assert _digests(st2) == before
    assert not os.path.exists(os.path.join(jdir, "JOURNAL.json"))


def test_resume_refuses_dirty_store(tmp_path):
    path = _release_file(tmp_path)
    sdir = os.path.join(str(tmp_path), "store")
    jdir = os.path.join(str(tmp_path), "journal")
    st = _sharded()
    st.save(sdir)
    cfg = IngestConfig(batch_entries=32)
    with pytest.raises(_Kill):
        ingest_release(st, path, P, 1, label="r", config=cfg,
                       journal_dir=jdir, store_dir=sdir,
                       on_batch=_killer_at(2))
    with pytest.raises(IngestResumeError):
        ingest_release(st, path, P, 1, label="r", config=cfg,
                       journal_dir=jdir, store_dir=sdir)
    # a reload from the directory resumes and ends at the JAX answer
    st2 = ShardedStore.load(sdir, device="cpu")
    ingest_release(st2, path, P, 1, label="r", config=cfg,
                   journal_dir=jdir, store_dir=sdir)
    assert _digests(st2) == _digests(_reference(path, _jsharded()))


def test_backpressure_pauses_waves(tmp_path):
    path = _release_file(tmp_path)
    level = {"v": 2.0}
    seen = []

    def pressure():
        seen.append(level["v"])
        v, level["v"] = level["v"], 0.0
        return v

    st = _sharded()
    rep = ingest_release(
        st, path, P, 1, label="r", pressure_fn=pressure,
        config=IngestConfig(batch_entries=64, max_pressure=1.0,
                            pressure_poll_s=0.001))
    assert rep.backpressure_waits >= 1
    assert rep.backpressure_wait_s > 0
    assert rep.n_entries == N
    assert seen[0] == 2.0
    assert _digests(st) == _digests(_reference(path, _jsharded()))


def test_ingest_observability(tmp_path):
    """Counters and the wave histogram advance per run; an aborted ingest
    leaves a flight-recorder event with the span's trace id."""
    path = _release_file(tmp_path)
    c_chunks = REGISTRY.counter("ingest.chunks_parsed")
    c_entries = REGISTRY.counter("ingest.entries_routed")
    h_wave = REGISTRY.histogram("ingest.wave_wall")
    base = (c_chunks.value, c_entries.value, h_wave.n)
    st = _sharded()
    rep = ingest_release(st, path, P, 1, label="r",
                         config=IngestConfig(batch_entries=64))
    assert c_chunks.value - base[0] == rep.n_chunks
    assert c_entries.value - base[1] == N
    assert h_wave.n - base[2] == rep.n_chunks
    assert h_wave.snapshot()["p99_ms"] >= h_wave.snapshot()["p50_ms"]

    with pytest.raises(_Kill):
        ingest_release(_sharded(), path, P, 1, label="r",
                       config=IngestConfig(batch_entries=64),
                       on_batch=_killer_at(1))
    ev = RECORDER.events("ingest_abort")[-1]
    assert ev["store"] == "ing" and ev["chunks_applied"] == 2
    assert ev.get("trace")


def test_snapshot_all_keys_match_jax(tmp_path):
    """``repro_torch.obs.snapshot_all`` after the same ingest in both
    packages: the same top-level keys, the same ingest metrics, the same
    flight-recorder layout."""
    path = _release_file(tmp_path, n=64)
    cfg = dict(batch_entries=64, queue_depth=0)
    jingest.ingest_release(
        jstore.VersionedStore("ing", JP.schema(), capacity=64), path, JP, 1,
        config=jingest.IngestConfig(**cfg))
    ingest_release(VersionedStore("ing", P.schema(), capacity=64,
                                  device="cpu"), path, P, 1,
                   config=IngestConfig(**cfg))
    js, ts = jobs.snapshot_all(), tobs.snapshot_all()
    assert set(js) == set(ts) == {"metrics", "kernels", "flight_recorder"}

    def ingest_keys(s):
        return {k for k in s["metrics"] if k.startswith("ingest.")}
    assert ingest_keys(ts) == ingest_keys(js) >= {
        "ingest.chunks_parsed", "ingest.entries_routed", "ingest.wave_wall"}
    assert set(ts["flight_recorder"]) == set(js["flight_recorder"])
    assert tobs.get_logger("ingest").name == "repro_torch.ingest"
    assert callable(tobs.configure_logging)


def test_ingest_journal_checkpoint_counts(tmp_path):
    path = _release_file(tmp_path)
    jdir = os.path.join(str(tmp_path), "journal")
    sdir = os.path.join(str(tmp_path), "store")
    st = _sharded()
    st.save(sdir)
    c_ckpt = REGISTRY.counter("ingest.checkpoint_writes")
    base = c_ckpt.value
    rep = ingest_release(st, path, P, 1, label="r",
                         config=IngestConfig(batch_entries=32),
                         journal_dir=jdir, store_dir=sdir)
    assert rep.checkpoint_writes == rep.n_chunks
    assert c_ckpt.value - base == rep.n_chunks


def test_stress_paced_ingest_with_concurrent_reads(tmp_path):
    """A release streams in (threaded waves, flapping backpressure) while
    readers query the committed version: they see only the pre-release
    snapshot until finish(), and the store ends at the JAX answer."""
    p1 = _release_file(tmp_path, seed=11)
    p2 = _release_file(tmp_path, seed=11, churn=0.4)
    ref = _reference(p2, _reference(p1, _jsharded()), ts=2, label="r2")

    st = _sharded()
    ingest_release(st, p1, P, 1, label="r",
                   config=IngestConfig(batch_entries=64))
    v1 = st.get_versions([1])[0]
    want = v1.values["sequence"].tobytes()
    flap = {"i": 0}

    def pressure():
        flap["i"] += 1
        return 2.0 if flap["i"] % 3 == 1 else 0.0

    errs, stop = [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                v = st.get_versions([1])[0]
                if v.values["sequence"].tobytes() != want:
                    errs.append("reader saw mutated pre-release view")
                    return
                time.sleep(0.001)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(repr(e))

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        rep = ingest_release(st, p2, P, 2, label="r2", pressure_fn=pressure,
                             config=IngestConfig(batch_entries=48,
                                                 max_pressure=1.0,
                                                 pressure_poll_s=0.001))
        assert rep.backpressure_waits >= 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not errs, errs
    assert _digests(st) == _digests(ref)
    assert np.array_equal(st.get_versions([1])[0].values["sequence"],
                          v1.values["sequence"])
    # the release the readers raced with is whole: no cell went missing
    got, want = st.get_versions([2])[0], ref.get_versions([2])[0]
    assert got.keys == want.keys
    for f in want.values:
        assert np.array_equal(got.values[f], want.values[f]), f


def test_log_keeps_cells_appended_while_a_reader_consolidates(monkeypatch):
    """A release session appends to a cell log while a reader consolidates
    it (``csr``): the append waits for the log's lock, so it is neither
    cleared away with the copied chunks nor hidden behind a stale CSR; and
    cells of rows a session created after the reader read ``n_rows`` stay
    in the log, after the rows the reader asked for."""
    import torch
    from repro_torch.core import store as tstore
    log = tstore._CellLog(2, np.dtype(np.int32), torch.device("cpu"))
    log.append(np.array([1, 0], np.int32), 1, np.ones((2, 2), np.int32))
    real, writers = np.lexsort, []

    def lexsort_with_a_writer(keys):
        if not writers:  # the writer comes while the reader consolidates
            w = threading.Thread(target=log.append, args=(
                np.array([0], np.int32), 2, np.full((1, 2), 7, np.int32)))
            writers.append(w)
            w.start()
            w.join(timeout=0.5)
        return real(keys)
    monkeypatch.setattr(np, "lexsort", lexsort_with_a_writer)
    vals, tss, ptr = log.csr(2)
    writers[0].join(timeout=5)
    assert not writers[0].is_alive()
    monkeypatch.undo()
    assert tss.tolist() == [1, 1] and ptr.tolist() == [0, 1, 2]
    vals, tss, ptr = log.csr(2)
    assert tss.tolist() == [1, 2, 1] and vals[1].tolist() == [7, 7]
    assert ptr.tolist() == [0, 2, 3] and log.n_cells == 3
    log.append(np.array([3, 2], np.int32), 3, np.full((2, 2), 5, np.int32))
    vals, tss, ptr = log.csr(2)  # rows 2 and 3 came after n_rows was read
    assert ptr.tolist() == [0, 2, 3] and len(tss) == 3
    vals, tss, ptr = log.csr(4)
    assert ptr.tolist() == [0, 2, 3, 4, 5] and tss.tolist() == [1, 2, 1, 3, 3]


# -- the facade: GeStore.add_release_stream and WorkflowManager.ingest_release

def _registries():
    from repro.core import PluginRegistry as JReg
    jreg, treg = JReg(), tcore.PluginRegistry()
    jreg.register_parser(JUniProt(seq_width=64, annot_width=32))
    treg.register_parser(UniProtParser(seq_width=64, annot_width=32))
    return jreg, treg


def test_add_release_stream_matches_jax(tmp_path):
    """Two releases streamed into a 2-shard store through the port's
    ``GeStore`` (resumable: journal, pre- and post-release saves) and
    through its ``WorkflowManager``; the JAX package's GeStore takes the
    same releases whole and flushes around each. Store directories, the
    `updates` rows and the digests are equal, and the journal is gone."""
    import repro.core as jcore
    from repro_torch.workflow import WorkflowManager
    jreg, treg = _registries()
    paths = [os.path.join(str(tmp_path), f"r{i}.dat") for i in (1, 2)]
    write_synth_uniprot(paths[0], 70, seed=4, seq_len=90)
    write_synth_uniprot(paths[1], 75, seed=4, churn=0.2, seq_len=90)
    jgs = jcore.GeStore(os.path.join(str(tmp_path), "j"), jreg)
    tgs = tcore.GeStore(os.path.join(str(tmp_path), "t"), treg, device="cpu")
    wf = WorkflowManager(tgs, [])
    cfg = IngestConfig(chunk_chars=1000, batch_entries=16)
    jgs.create_store("sp", jreg.parsers["uniprot_dat"].schema(), shards=2)
    for ts, p in zip((10, 20), paths):
        jgs.flush("sp")  # the stream's pre-release save
        with open(p) as f:
            jgs.add_release("sp", ts, f.read(), parser_name="uniprot_dat")
        jgs.flush("sp")
        if ts == 10:
            rep = tgs.add_release_stream("sp", ts, p,
                                         parser_name="uniprot_dat",
                                         shards=2, config=cfg)
        else:
            rep = wf.ingest_release("sp", ts, p, parser_name="uniprot_dat",
                                    config=cfg)
        assert rep.n_entries == (70 if ts == 10 else 75)
        assert rep.info.n_entries == jgs.stores["sp"].versions[-1].n_entries
    assert _digests(tgs.stores["sp"]) == _digests(jgs.stores["sp"])
    assert _tree(tgs.store_path("sp")) == _tree(jgs.store_path("sp"))
    assert [vars(u) for u in tgs.tables.updates] == \
        [vars(u) for u in jgs.tables.updates]
    assert not os.path.exists(os.path.join(
        tgs.ingest_journal_path("sp"), "JOURNAL.json"))
    assert os.path.relpath(tgs.ingest_journal_path("sp"), tgs.root) == \
        os.path.relpath(jgs.ingest_journal_path("sp"), jgs.root)
    run = [r for r in tgs.tables.runs.values()][-1]
    assert run.status == "done" and run.inputs == [paths[1]]
    chunks = list(read_file_chunks(paths[1], 333, start=100))
    assert chunks == list(jingest.read_file_chunks(paths[1], 333, start=100))
