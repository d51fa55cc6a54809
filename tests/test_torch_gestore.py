"""The port's GeStore facade (``repro_torch.core``: ``GeStore``, the
cache, the system tables, the mergers, ``change``, and
``repro_torch.workflow``) against the JAX package's, on the CPU.

The cases of ``tests/test_increment_engine.py``, the workflow case of
``tests/test_data_serve_workflow.py`` and the facade cases of
``tests/test_sharded_store.py`` run through both packages side by side
(the port with ``device="cpu"``), each in its own root. They compare,
exactly: generated file bytes, cache paths relative to each root, merge
contexts and outputs, store directories after ``flush``, history digests,
and the system tables' rows without their wall-clock fields, with paths
relative to each root.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.parsers import FastaParser as JFasta  # noqa: E402
from repro.core.parsers import UniProtParser as JUniProt  # noqa: E402
from repro.workflow.manager import Tool as JTool  # noqa: E402
from repro.workflow.manager import WorkflowManager as JWorkflow  # noqa: E402
from repro_torch.core.parsers import FastaParser as TFasta  # noqa: E402
from repro_torch.core.parsers import UniProtParser as TUniProt  # noqa: E402
from repro_torch.core.ingest import synth_uniprot_chunks  # noqa: E402
from repro_torch.workflow import Tool as TTool  # noqa: E402
from repro_torch.workflow import WorkflowManager as TWorkflow  # noqa: E402


def mk_fasta(n, mut=(), drop=(), rng_seed=7):
    """``tests/test_increment_engine.py``'s release generator."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 30))
        if i in drop:
            continue
        if i in mut:
            seq = seq[:5] + "WWWWW" + seq[10:]
        out.append(f">SEQ{i:04d} desc {i}\n{seq}\n")
    return "".join(out)


def registry(core, fasta_cls, **params):
    reg = core.PluginRegistry()
    reg.register_parser(fasta_cls(seq_width=64, desc_width=16))
    reg.register_tool(core.ToolPlugin(
        "blastp",
        core.FileGenerator(parser="fasta",
                           output_fields=["sequence", "length", "desc"],
                           significant_fields=["sequence", "length"]),
        merger=core.BlastEvalueMerger(), params=dict(params)))
    return reg


class Pair:
    """One GeStore of each package over its own root, fed the same calls."""

    def __init__(self, root, jreg, treg, **kw):
        self.roots = (os.path.join(str(root), "jax"),
                      os.path.join(str(root), "torch"))
        self.j = jcore.GeStore(self.roots[0], jreg, **kw)
        self.t = tcore.GeStore(self.roots[1], treg, device="cpu", **kw)

    def both(self, name, *args, **kw):
        return (getattr(self.j, name)(*args, **kw),
                getattr(self.t, name)(*args, **kw))

    def reopen(self, jreg, treg, **kw):
        self.j = jcore.GeStore(self.roots[0], jreg, **kw)
        self.t = tcore.GeStore(self.roots[1], treg, device="cpu", **kw)


def rel(path, root):
    return os.path.relpath(path, root) if path else path


def same_generated(pair, a, b):
    """Two GeneratedInputs: equal fields, merge context and file bytes,
    cache paths equal relative to each root."""
    assert (a.mode, a.t0, a.t1, a.n_entries) == (b.mode, b.t0, b.t1,
                                                  b.n_entries)
    assert a.context == b.context
    assert rel(a.path, pair.roots[0]) == rel(b.path, pair.roots[1])
    with open(a.path, "rb") as fa, open(b.path, "rb") as fb:
        assert fa.read() == fb.read()


def table_rows(tables, root):
    """SystemTables rows without wall-clock fields, paths relative to the
    root, runs keyed by (tool, inputs) since run ids carry a clock."""
    files = {}
    for k, r in tables.files.items():
        d = dataclasses.asdict(r)
        d.pop("created"), d.pop("last_used")
        d["path"] = rel(d["path"], root)
        files[k] = d
    runs = []
    for r in tables.runs.values():
        d = dataclasses.asdict(r)
        for f in ("run_id", "wall_start", "wall_end"):
            d.pop(f)
        d["inputs"] = [rel(p, root) if os.path.isabs(p) else p
                       for p in d["inputs"]]
        runs.append(d)
    runs.sort(key=repr)
    return ([dataclasses.asdict(u) for u in tables.updates], files, runs)


def same_tables(pair):
    assert table_rows(pair.j.tables, pair.roots[0]) == \
        table_rows(pair.t.tables, pair.roots[1])


def tree_bytes(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def digests(st):
    if hasattr(st, "n_shards"):
        return [st.shard(i)._history_digest for i in range(st.n_shards)]
    return [st._history_digest]


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path, registry(jcore, JFasta), registry(tcore, TFasta))
    for args in ((100, mk_fasta(50)), (200, mk_fasta(55, mut={3, 7},
                                                     drop={11}))):
        infos = p.both("add_release", "up", *args, parser_name="fasta")
        assert dataclasses.asdict(infos[0]) == dataclasses.asdict(infos[1])
    assert digests(p.t.stores["up"]) == digests(p.j.stores["up"])
    assert p.t.stores["up"].device.type == "cpu"
    return p


# -- tests/test_increment_engine.py --------------------------------------------

def test_full_and_incremental_generation(pair):
    full = pair.both("generate_files", "blastp", "up", t_version=100)
    same_generated(pair, *full)
    assert full[1].mode == "full" and full[1].n_entries == 50
    inc = pair.both("generate_files", "blastp", "up", t_version=200,
                    t_last=100)
    same_generated(pair, *inc)
    assert inc[1].mode == "increment" and inc[1].n_entries == 7
    assert len(inc[1].context["deleted_keys"]) == 1
    assert len(inc[1].context["updated_keys"]) == 2
    assert inc[1].context["db_size_new"] > 0
    same_tables(pair)


def test_cache_hit_and_eviction(pair):
    a = pair.both("generate_files", "blastp", "up", t_version=100)
    b = pair.both("generate_files", "blastp", "up", t_version=100)
    same_generated(pair, *b)
    assert b[1].mode == "cached" and b[1].path == a[1].path
    assert pair.t.cache.hits == pair.j.cache.hits >= 1
    assert pair.t.cache.misses == pair.j.cache.misses
    n = (pair.j.cache.evict(0), pair.t.cache.evict(0))
    assert n[0] == n[1] >= 1
    c = pair.both("generate_files", "blastp", "up", t_version=100)
    same_generated(pair, *c)
    assert c[1].mode == "full"
    same_tables(pair)


def test_pinned_version_reproducibility(pair):
    v1a = pair.both("generate_files", "blastp", "up", t_version=100)
    pair.both("add_release", "up", 300, mk_fasta(60, mut={1}),
              parser_name="fasta")
    v1b = pair.both("generate_files", "blastp", "up", t_version=100)
    same_generated(pair, *v1b)
    for a, b in zip(v1a, v1b):
        with open(a.path) as fa, open(b.path) as fb:
            assert fa.read() == fb.read()


def test_taxon_filter(pair):
    f = pair.both("generate_files", "blastp", "up", t_version=100,
                  key_filter=r"SEQ000")
    same_generated(pair, *f)
    assert f[1].n_entries == 10


@pytest.mark.parametrize("deleted,updated", [([b"S2"], []),
                                             (["S1"], [b"S3"]),
                                             ([], [])])
def test_evalue_merger_matches_jax(deleted, updated):
    prev = "q1\tS1\t90.0\t30\t3\t0\t1\t30\t1\t30\t1.0e-10\t50.0\n" \
           "q1\tS2\t80.0\t30\t6\t0\t1\t30\t1\t30\t1.0e-05\t40.0\n" \
           "# comment\n" \
           "q2\tS1\t70.0\t30\t6\t0\t1\t30\t1\t30\t0\t40.0\n"
    partial = "q1\tS3\t95.0\t30\t1\t0\t1\t30\t1\t30\t2.0e-12\t60.0\n"
    ctx = {"db_size_old": 1000, "db_size_new": 2000, "deleted_keys": deleted,
           "updated_keys": updated, "max_hits_per_query": 10}
    got = tcore.BlastEvalueMerger().merge(prev, partial, context=ctx)
    assert got == jcore.BlastEvalueMerger().merge(prev, partial, context=ctx)
    if deleted == [b"S2"]:
        lines = got.strip().splitlines()
        ev = {ln.split("\t")[1]: float(ln.split("\t")[10])
              for ln in lines if ln.startswith("q1")}
        assert set(ev) == {"S1", "S3"}
        assert math.isclose(ev["S1"], 2.0e-10, rel_tol=0.05)
        assert math.isclose(ev["S3"], 2.0e-12, rel_tol=0.05)
        assert lines[0].split("\t")[1] == "S3"
    amerge = {"deleted_keys": [k.decode() if isinstance(k, bytes) else k
                               for k in deleted]}
    prev_a = "c1|g1\t1\nc2|g1\t2\n#x\nS1\t3\n"
    part_a = "c2|g9\t5\nS3\t6\n"
    assert tcore.AppendMerger().merge(prev_a, part_a, context=amerge) == \
        jcore.AppendMerger().merge(prev_a, part_a, context=amerge)


def test_run_tool_provenance(pair):
    def tool(path):
        n = open(path).read().count(">")
        return f"q1\tS1\t90.0\t{n}\t0\t0\t1\t30\t1\t30\t1e-10\t50.0\n"

    full = pair.both("run_tool", "blastp", "up", tool, t_version=100)
    assert full[0][0] == full[1][0] and "q1" in full[1][0]
    same_generated(pair, full[0][1], full[1][1])
    inc = pair.both("run_tool", "blastp", "up", tool, t_version=200,
                    t_last=100, previous_output=full[1][0])
    assert inc[0][0] == inc[1][0]
    same_generated(pair, inc[0][1], inc[1][1])
    runs = list(pair.t.tables.runs.values())
    assert any(r.tool == "blastp" and r.status == "done" for r in runs)
    same_tables(pair)


# -- the batched path, classify, the merge entry point --------------------------

def test_generate_files_batch_matches_jax(pair):
    """A mixed batch twice: full versions, increments, a filter, a
    duplicate; then all cached. Then merge_files on the increment."""
    reqs = [{"tool": "blastp", "store": "up", "t_version": 200},
            {"tool": "blastp", "store": "up", "t_version": 100},
            {"tool": "blastp", "store": "up", "t_version": 200,
             "t_last": 100},
            {"tool": "blastp", "store": "up", "t_version": 200,
             "key_filter": r"SEQ00[1-3]"},
            {"tool": "blastp", "store": "up", "t_version": 200,
             "t_last": 100, "key_filter": r"SEQ005"},
            {"tool": "blastp", "store": "up", "t_version": 100}]
    first = pair.both("generate_files_batch", reqs)
    for a, b in zip(*first):
        same_generated(pair, a, b)
    assert [g.mode for g in first[1]] == ["full", "full", "increment",
                                          "full", "increment", "cached"]
    again = pair.both("generate_files_batch", reqs)
    for a, b in zip(*again):
        same_generated(pair, a, b)
    assert {g.mode for g in again[1]} == {"cached"}
    inc = first[1][2]
    assert tcore.classify(pair.t.stores["up"].get_increment(100, 200)) == \
        jcore.classify(pair.j.stores["up"].get_increment(100, 200))
    prev = "q1\tSEQ0003\t90.0\t30\t3\t0\t1\t30\t1\t30\t1.0e-10\t50.0\n"
    part = "q1\tSEQ0052\t95.0\t30\t1\t0\t1\t30\t1\t30\t2.0e-12\t60.0\n"
    merged = pair.both("merge_files", "blastp", prev, part,
                       context=inc.context)
    assert merged[0] == merged[1] and "SEQ0003" not in merged[1]
    same_tables(pair)


def test_flush_dirs_identical_and_reopen_on_cpu(pair):
    """flush() writes byte-identical store directories; each package
    reopens its root lazily and gives the same files; the port's GeStore
    over the JAX package's root too."""
    pair.both("generate_files", "blastp", "up", t_version=200, t_last=100)
    stats = pair.both("flush")
    assert stats[0] == stats[1]
    assert tree_bytes(pair.j.store_path("up")) == \
        tree_bytes(pair.t.store_path("up"))
    same_tables(pair)
    pair.reopen(registry(jcore, JFasta), registry(tcore, TFasta))
    st = pair.t.open_store("up")
    assert st.device.type == "cpu" and digests(st) == digests(
        pair.j.open_store("up"))
    a = pair.both("generate_files", "blastp", "up", t_version=200,
                  t_last=100)
    same_generated(pair, *a)
    assert a[1].mode == "cached"
    cross = tcore.GeStore(pair.roots[0], registry(tcore, TFasta),
                          device="cpu")
    assert digests(cross.open_store("up")) == digests(st)
    cross.cache.evict(0)
    got = cross.generate_files("blastp", "up", t_version=200)
    want = pair.j.generate_files("blastp", "up", t_version=200)
    assert open(got.path, "rb").read() == open(want.path, "rb").read()


def test_uniprot_store_dirs_identical(tmp_path):
    """UniProt's int8 sequence and annotation rows and int32 fields
    through add_release, flush and a full version: the same files and
    directories in both packages (the facade's widths, cut to 64 / 32)."""
    regs = []
    for core, cls in ((jcore, JUniProt), (tcore, TUniProt)):
        reg = core.PluginRegistry()
        reg.register_parser(cls(seq_width=64, annot_width=32))
        reg.register_tool(core.ToolPlugin("annot", core.FileGenerator(
            parser="uniprot_dat", output_fields=["sequence"],
            significant_fields=["annotation"])))
        regs.append(reg)
    p = Pair(tmp_path, *regs)
    text1 = "".join(synth_uniprot_chunks(40, seed=3, seq_len=70))
    text2 = "".join(synth_uniprot_chunks(44, seed=3, churn=0.3, seq_len=70))
    for ts, text in ((10, text1), (20, text2)):
        infos = p.both("add_release", "sp", ts, text,
                       parser_name="uniprot_dat", shards=2)
        assert dataclasses.asdict(infos[0]) == dataclasses.asdict(infos[1])
    reqs = [{"tool": "annot", "store": "sp", "t_version": 20},
            {"tool": "annot", "store": "sp", "t_version": 20, "t_last": 10}]
    for a, b in zip(*p.both("generate_files_batch", reqs)):
        same_generated(p, a, b)
    stats = p.both("flush")
    assert stats[0] == stats[1]
    assert tree_bytes(p.j.store_path("sp")) == tree_bytes(p.t.store_path("sp"))
    same_tables(p)


# -- tests/test_data_serve_workflow.py -----------------------------------------

def _wf_fasta(n, mut=(), seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 24))
        if i in mut:
            seq = "WWWW" + seq[4:]
        out.append(f">S{i:03d}\n{seq}\n")
    return "".join(out)


def _toy_blast(args):
    path = next(p for k, p in args.items() if k.startswith("store:"))
    text = open(path).read()
    out = []
    for entry in text.split(">")[1:]:
        sid = entry.splitlines()[0].split()[0]
        seq = "".join(entry.splitlines()[1:])
        score = sum(map(ord, seq)) % 97
        out.append(f"q0\t{sid}\t90.0\t24\t0\t0\t1\t24\t1\t24\t"
                   f"{10 ** -(score % 20):.1e}\t{50 + score % 30}.0")
    return "\n".join(out) + "\n"


def test_workflow_incremental_equals_full(tmp_path):
    regs = []
    for core, cls in ((jcore, JFasta), (tcore, TFasta)):
        reg = core.PluginRegistry()
        reg.register_parser(cls(seq_width=64, desc_width=8))
        reg.register_tool(core.ToolPlugin(
            "blast", core.FileGenerator(
                parser="fasta", output_fields=["sequence", "length", "desc"],
                significant_fields=["sequence", "length"]),
            merger=core.BlastEvalueMerger(),
            params={"max_hits_per_query": 10_000}))
        regs.append(reg)
    p = Pair(tmp_path, *regs)
    p.both("add_release", "up", 1, _wf_fasta(30), parser_name="fasta")
    p.both("add_release", "up", 2, _wf_fasta(33, mut={2, 9}),
           parser_name="fasta")
    outs = []
    for gs, tool_cls, wf_cls in ((p.j, JTool, JWorkflow),
                                 (p.t, TTool, TWorkflow)):
        wf = wf_cls(gs, [tool_cls("blast", _toy_blast, ["store:up"])])
        r1 = wf.run(db_version=1)
        r2_inc = wf.run(db_version=2, last_version=1)
        r2_full = wf_cls(gs, [tool_cls("blast", _toy_blast,
                                       ["store:up"])]).run(db_version=2)
        assert r1.mode == "full" and r2_inc.mode == "incremental"
        assert r2_inc.generated["blast/store:up"] == "increment"
        outs.append((r1.outputs, r2_inc.outputs, r2_full.outputs,
                     r2_inc.generated, r2_full.generated))

    def parse(text):
        rows = {}
        for ln in text.strip().splitlines():
            c = ln.split("\t")
            rows[c[1]] = (c[2], c[11])
        return rows

    assert outs[0] == outs[1]
    assert parse(outs[1][1]["blast"]) == parse(outs[1][2]["blast"])
    same_tables(p)


# -- tests/test_sharded_store.py, the GeStore cases ------------------------------

def test_gestore_creates_flushes_and_reopens_sharded(tmp_path):
    regs = []
    for core, cls in ((jcore, JFasta), (tcore, TFasta)):
        reg = core.PluginRegistry()
        reg.register_parser(cls(seq_width=8, desc_width=2))
        regs.append(reg)
    p = Pair(tmp_path, *regs)
    p.both("add_release", "up", 1, ">A x\nACDE\n>B y\nACDF\n",
           parser_name="fasta", shards=2)
    assert isinstance(p.t.stores["up"], tcore.ShardedStore)
    p.both("add_release", "up", 2, ">A x\nACDE\n>C z\nGGGG\n",
           parser_name="fasta")
    stats = p.both("flush")
    assert stats[0] == stats[1] and stats[1]["up"]["n_shards"] == 2
    assert tree_bytes(p.j.store_path("up")) == tree_bytes(p.t.store_path("up"))
    same_tables(p)
    p.reopen(*regs)
    st = p.t.open_store("up")
    assert isinstance(st, tcore.ShardedStore) and st.device.type == "cpu"
    assert sorted(st.get_version(2).keys) == [b"A", b"C"]
    assert set(st.get_increment(1, 2).keys) == {b"B", b"C"}
    assert digests(st) == digests(p.j.open_store("up"))
    with pytest.raises(ValueError):
        p.t.create_store("up", [], shards=3)


def test_version_cache_byte_budget(tmp_path):
    caches = [core.VersionCache(str(tmp_path / name), max_bytes=64)
              for core, name in ((jcore, "j"), (tcore, "t"))]

    def put(cache, i):
        return cache.put(f"file-{i}|0|1",
                         lambda p: open(p, "w").write("x" * 40),
                         suffix=".txt")
    for i in range(3):
        paths = [put(c, i) for c in caches]
        assert os.path.relpath(paths[0], str(tmp_path / "j")) == \
            os.path.relpath(paths[1], str(tmp_path / "t"))
        assert os.path.exists(paths[1])
        if i:
            assert not os.path.exists(prev)
            for c in caches:
                assert c.get(f"file-{i - 1}|0|1") is None
        prev = paths[1]
    for c in caches:
        assert c.get("file-2|0|1") is not None
    assert (caches[1].hits, caches[1].misses) == (caches[0].hits,
                                                  caches[0].misses)
    desc = tcore.descriptor("up", 1, 2, filter_expr="P0.*", plugin="b",
                            params={"z": 1, "a": [2]}, run_id="r", task_id="t")
    assert desc == jcore.descriptor("up", 1, 2, filter_expr="P0.*",
                                    plugin="b", params={"z": 1, "a": [2]},
                                    run_id="r", task_id="t")


def test_gestore_cache_budget_wired(tmp_path):
    reg = tcore.PluginRegistry()
    reg.register_parser(TFasta(seq_width=8, desc_width=2))
    gs = tcore.GeStore(str(tmp_path / "gs"), reg, device="cpu",
                       cache_max_bytes=123)
    assert gs.cache.max_bytes == 123


def test_gestore_without_device_is_the_card(tmp_path):
    """No ``device=``: the stores go to the CUDA card, and where there is
    none the constructor raises rather than fall back to the host."""
    reg = tcore.PluginRegistry()
    if torch.cuda.is_available():
        gs = tcore.GeStore(str(tmp_path / "gs"), reg)
        assert gs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.GeStore(str(tmp_path / "gs"), reg)
