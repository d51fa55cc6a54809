"""MetaGeneAnnotator (MGA) output parser.

MGA emits, per input contig, a `# <contig>` header followed by predicted
gene rows: `gene_id start end strand frame complete score ...`. One store
row per predicted gene, keyed contig|gene_id.
"""
from __future__ import annotations

import numpy as np

from .._schema_compat import FieldSchema
from ..plugins import FileParser


class MgaParser(FileParser):
    format_name = "mga"

    def entry_pattern(self):
        return (r"^# ", r"(?=^# )|\Z")

    def schema(self):
        return [
            FieldSchema("coords", 3, "int32"),   # start, end, strand(+1/-1)
            FieldSchema("score", 1, "float32"),
        ]

    def split_entry(self, entry: str):
        # one *contig block*; framework-level iter_records flattens genes
        raise NotImplementedError("use iter_records / parse_text (block format)")

    def iter_records(self, chunks):
        # block format: a line-granular state machine carrying the active
        # contig across chunk boundaries (and across `# gc`/`# self` stats
        # lines, which must not reset it). parse_text rides on this, so
        # chunked and whole-file parses share one code path.
        contig = ""
        tail = ""
        for chunk in chunks:
            if not chunk:
                continue
            parts = (tail + chunk).split("\n")
            tail = parts.pop()
            for line in parts:
                rec, contig = self._line_record(line, contig)
                if rec is not None:
                    yield rec
        if tail:
            rec, contig = self._line_record(tail, contig)
            if rec is not None:
                yield rec

    def _line_record(self, line: str, contig: str):
        """One MGA output line -> (record | None, active contig)."""
        if line.startswith("# gc") or line.startswith("# self"):
            return None, contig  # MGA stats headers
        if line.startswith("#"):
            return None, line[1:].strip().split()[0]
        cols = line.split()
        if len(cols) < 7:
            return None, contig
        gene_id, start, end, strand = cols[0], int(cols[1]), int(cols[2]), cols[3]
        score = float(cols[6])
        key = f"{contig}|{gene_id}".encode()
        row = {"coords": np.asarray([start, end, 1 if strand == "+" else -1],
                                    np.int32),
               "score": np.asarray([score], np.float32)}
        return (key, row), contig

    def format_entry(self, key: bytes, row: dict[str, np.ndarray]) -> str:
        contig, gene = key.decode().split("|")
        s, e, st = (int(v) for v in row["coords"])
        return (f"# {contig}\n{gene}\t{s}\t{e}\t{'+' if st > 0 else '-'}\t0\t11"
                f"\t{float(row['score'][0]):.2f}\n")
