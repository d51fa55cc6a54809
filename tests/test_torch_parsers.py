"""The port's format parsers (``repro_torch.core.parsers`` and the
streaming entry splitter of ``repro_torch.core.plugins``) against the JAX
package's, case for case with ``tests/test_parsers.py``: the same keys,
the same row bytes, the same formatted text and the same entry offsets,
whole-file and chunked at any boundary, exactly."""
import numpy as np
import pytest
from _hyp import given, settings, st

pytest.importorskip("torch")

from repro.core import parsers as jp  # noqa: E402
from repro_torch.core import parsers as tp  # noqa: E402

FASTA = """>P00001 subunit alpha
MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ
>P00002
ACDEFGHIKLMNPQRSTVWY
"""

UNIPROT = """ID   TEST1_HUMAN             Reviewed;          33 AA.
AC   P00001; Q9999;
DE   RecName: Full=Test protein 1;
GN   Name=TST1;
OS   Homo sapiens (Human).
OX   NCBI_TaxID=9606;
KW   Test; Example.
SQ   SEQUENCE   33 AA;  3707 MW;  DEADBEEF CRC64;
     MKTAYIAKQR QISFVKSHFS RQLEERLGLI EVQ
//
ID   TEST2_ECOLI             Reviewed;          20 AA.
AC   P00002;
OS   Escherichia coli.
OX   NCBI_TaxID=562;
SQ   SEQUENCE   20 AA;  2202 MW;  CAFEBABE CRC64;
     ACDEFGHIKL MNPQRSTVWY
//
"""

BLAST = "q1\tP00001\t98.500\t33\t1\t0\t1\t33\t1\t33\t1.2e-15\t68.2\n" \
        "q1\tP00002\t45.000\t20\t11\t0\t1\t20\t1\t20\t0.001\t32.1\n"

MGA = """# contig001
gene_1\t100\t400\t+\t0\t11\t8.21\t
gene_2\t500\t800\t-\t0\t11\t5.10\t
# contig002
gene_1\t1\t250\t+\t0\t11\t12.00\t
"""

# (name, constructor kwargs, text): each parser built in both packages
_CASES = [
    ("FastaParser", {"seq_width": 64, "desc_width": 32}, FASTA),
    ("UniProtParser", {"seq_width": 64}, UNIPROT),
    ("BlastTabParser", {}, BLAST),
    ("MgaParser", {}, MGA),
]
_IDS = [c[0] for c in _CASES]


def pair(name, kw):
    """(JAX package's parser, the port's) of one format."""
    return getattr(jp, name)(**kw), getattr(tp, name)(**kw)


def _split(text: str, size: int) -> list[str]:
    return [text[i:i + size] for i in range(0, len(text), size)]


def _whole(parser, text):
    keys, table = parser.parse_text(text)
    return keys, {n: (v.dtype.str, v.shape, v.tobytes())
                  for n, v in table.items()}


def _chunked(parser, chunks):
    keys, rows = [], []
    for k, r in parser.iter_records(chunks):
        keys.append(k)
        rows.append(r)
    if not rows:
        return [], {}
    return keys, {n: (v.dtype.str, v.shape, v.tobytes())
                  for n, v in parser.stack_rows(rows).items()}


@pytest.mark.parametrize("name,kw,text", _CASES, ids=_IDS)
def test_parse_and_format_match_jax(name, kw, text):
    """Whole-file parse, schema, empty table and every row's formatted
    entry, equal to the JAX package's; the reference test's own checks
    hold on the port."""
    j, t = pair(name, kw)
    assert [(f.name, f.width, f.dtype) for f in t.schema()] == \
        [(f.name, f.width, f.dtype) for f in j.schema()]
    assert t.format_name == j.format_name
    assert t.entry_pattern() == j.entry_pattern()
    assert _whole(t, text) == _whole(j, text)
    keys, table = t.parse_text(text)
    for i, k in enumerate(keys):
        row = {n: table[n][i] for n in table}
        assert t.format_entry(k, row) == j.format_entry(k, row)
        assert t.compare(row, row) and t.validate(row, list(row))
    assert {n: v.shape for n, v in t.empty_table().items()} == \
        {n: v.shape for n, v in j.empty_table().items()}
    if name == "FastaParser":
        assert [k.decode() for k in keys] == ["P00001", "P00002"]
        assert table["length"][0, 0] == 33
        out = "".join(t.format_entry(k, {n: table[n][i] for n in table})
                      for i, k in enumerate(keys))
        assert _whole(t, out)[0] == keys
    elif name == "UniProtParser":
        assert table["taxid"][:, 0].tolist() == [9606, 562]
        assert table["annotation"][0].any()
    elif name == "BlastTabParser":
        assert abs(10 ** table["log10_evalue"][0, 0] - 1.2e-15) < 1e-16
        line = t.format_entry(keys[0], {n: table[n][0] for n in table})
        assert t.parse_text(line)[0][0] == keys[0]
    else:
        assert [k.decode() for k in keys] == [
            "contig001|gene_1", "contig001|gene_2", "contig002|gene_1"]
        assert np.array_equal(table["coords"][1], [500, 800, -1])


@pytest.mark.parametrize("name,kw,text", _CASES, ids=_IDS)
@pytest.mark.parametrize("size", [1, 2, 3, 7, 64, 1000])
def test_chunk_split_matches_jax_whole(name, kw, text, size):
    """Every chunk size, down to one char: the port's chunked parse equals
    the JAX package's whole-file parse and its own chunked parse."""
    j, t = pair(name, kw)
    got = _chunked(t, _split(text, size))
    assert got == _whole(j, text)
    assert got == _chunked(j, _split(text, size))


@pytest.mark.parametrize("name,kw,text",
                         [c for c in _CASES if c[0] != "BlastTabParser"],
                         ids=[i for i in _IDS if i != "BlastTabParser"])
def test_chunk_split_truncated_record_matches_jax(name, kw, text):
    j, t = pair(name, kw)
    cut = text[:int(len(text) * 0.8)]
    for size in (1, 5, 37):
        assert _chunked(t, _split(cut, size)) == _whole(j, cut)
    assert _whole(t, cut) == _whole(j, cut)


def test_chunk_split_truncated_line_fails_identically():
    """A BLAST line cut mid-record: both packages raise ValueError whole
    and chunked, and split the same entries."""
    j, t = pair("BlastTabParser", {})
    cut = BLAST[:int(len(BLAST) * 0.8)]
    for p in (j, t):
        with pytest.raises(ValueError):
            _whole(p, cut)
    for size in (1, 5, 37):
        with pytest.raises(ValueError):
            _chunked(t, _split(cut, size))
        entries = list(t.iter_entries_chunks(_split(cut, size)))
        assert entries == list(j.iter_entries(cut))
        assert entries[0] == BLAST.splitlines(keepends=True)[0]


def test_chunk_split_leading_junk_dropped():
    j, t = pair("FastaParser", {"seq_width": 64, "desc_width": 32})
    noisy = "; stray comment\nnot a header\n" + FASTA
    for size in (1, 4, 999):
        assert _chunked(t, _split(noisy, size)) == _whole(j, noisy)


def test_entry_offsets_match_jax():
    """``iter_entries_with_offsets``: the same (entry, end offset) pairs
    as the JAX package at every chunk size, and each offset a resume
    point."""
    j, t = pair("UniProtParser", {"seq_width": 64})
    for size in (1, 11, 4096):
        pairs = list(t.iter_entries_with_offsets(_split(UNIPROT, size)))
        assert pairs == list(j.iter_entries_with_offsets(
            _split(UNIPROT, size)))
    entries = [e for e, _ in pairs]
    for i, (_, off) in enumerate(pairs):
        assert list(t.iter_entries(UNIPROT[off:])) == entries[i + 1:]


def test_parse_chunks_batches_match_jax():
    """``parse_chunks``: the same (keys, table) batches in both packages."""
    j, t = pair("UniProtParser", {"seq_width": 64})
    text = UNIPROT * 3
    got = [(k, {n: v.tobytes() for n, v in tb.items()})
           for k, tb in t.parse_chunks(_split(text, 13), batch_entries=2)]
    want = [(k, {n: v.tobytes() for n, v in tb.items()})
            for k, tb in j.parse_chunks(_split(text, 13), batch_entries=2)]
    assert got == want and len(got) == 3


@given(st.data())
@settings(max_examples=30, deadline=None)
def test_chunk_split_property_random_boundaries(data):
    """Any partition into chunks, empty chunks included: the port's
    chunked parse equals the JAX package's whole-file parse."""
    name, kw, text = _CASES[data.draw(
        st.integers(0, len(_CASES) - 1), label="case")]
    j, t = pair(name, kw)
    cuts = sorted(data.draw(
        st.lists(st.integers(0, len(text)), max_size=12), label="cuts"))
    bounds = [0] + cuts + [len(text)]
    chunks = [text[a:b] for a, b in zip(bounds, bounds[1:])]
    assert _chunked(t, chunks) == _whole(j, text)
