"""BLAST tabular (-outfmt 6) parser: 12 columns, one hit per line.

qseqid sseqid pident length mismatch gapopen qstart qend sstart send evalue
bitscore. The e-value column is the aggregate the incremental merger must
fix (paper §III.A / §IV.B): E = K*m*n*exp(-lambda*S) scales linearly with
database size m, so hits computed against an increment or an old release
are rescaled by m_new/m_old at merge time.
"""
from __future__ import annotations

import numpy as np

from .._schema_compat import FieldSchema
from ..plugins import FileParser

_INT_COLS = ["length", "mismatch", "gapopen", "qstart", "qend", "sstart", "send"]


class BlastTabParser(FileParser):
    format_name = "blast_tab"

    def entry_pattern(self):
        return (r"^[^\s#]", r"$")

    def schema(self):
        return [
            FieldSchema("ints", len(_INT_COLS), "int32"),    # 7 int columns
            FieldSchema("pident", 1, "float32"),
            FieldSchema("log10_evalue", 1, "float32"),
            FieldSchema("bitscore", 1, "float32"),
        ]

    def split_entry(self, entry: str):
        cols = entry.strip().split("\t")
        if len(cols) != 12:
            cols = entry.strip().split()
        (qseqid, sseqid, pident, length, mismatch, gapopen, qstart, qend,
         sstart, send, evalue, bitscore) = cols
        key = f"{qseqid}|{sseqid}|{qstart}|{sstart}".encode()
        ev = float(evalue)
        log_ev = np.float32(np.log10(ev)) if ev > 0 else np.float32(-400.0)
        return key, {
            "ints": np.asarray([int(length), int(mismatch), int(gapopen),
                                int(qstart), int(qend), int(sstart), int(send)],
                               np.int32),
            "pident": np.asarray([float(pident)], np.float32),
            "log10_evalue": np.asarray([log_ev], np.float32),
            "bitscore": np.asarray([float(bitscore)], np.float32),
        }

    def format_entry(self, key: bytes, row: dict[str, np.ndarray]) -> str:
        qseqid, sseqid, _q, _s = key.decode().split("|")
        ints = row["ints"].astype(int)
        ev = 10.0 ** float(row["log10_evalue"][0])
        return ("\t".join([
            qseqid, sseqid, f"{float(row['pident'][0]):.3f}",
            *[str(int(v)) for v in ints],
            f"{ev:.2e}", f"{float(row['bitscore'][0]):.1f}",
        ]) + "\n")
