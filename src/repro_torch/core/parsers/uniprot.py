"""UniProtKB flat-file (.dat) parser.

Entries run from an `ID` line to `//`. We parse the fields Meta-pipe's BLAST
stage cares about plus the frequently-churning annotation block, kept as a
separate column so tool-specific change detection can ignore it (the paper's
central example: most UniProtKB release churn is annotation-only and must
not trigger BLAST increments).
"""
from __future__ import annotations

import numpy as np

from .._schema_compat import FieldSchema
from ..plugins import FileParser
from ._text import pad_bytes, unpad_bytes

#: BLAST-significant fields for UniProtKB (paper §III.A)
BLAST_SIGNIFICANT = ("sequence", "length")


class UniProtParser(FileParser):
    format_name = "uniprot_dat"

    def __init__(self, seq_width: int = 512, annot_width: int = 256):
        self.seq_width = seq_width
        self.annot_width = annot_width

    def entry_pattern(self):
        return (r"^ID\s", r"^//$")

    def schema(self):
        return [
            FieldSchema("sequence", self.seq_width, "int8"),
            FieldSchema("length", 1, "int32"),
            FieldSchema("annotation", self.annot_width, "int8"),
            FieldSchema("taxid", 1, "int32"),
        ]

    def split_entry(self, entry: str):
        key = b""
        seq_lines: list[str] = []
        annot_lines: list[str] = []
        taxid = 0
        in_seq = False
        entry_name = ""
        for line in entry.splitlines():
            tag = line[:2]
            if tag == "ID":
                entry_name = line[2:].split()[0] if line[2:].split() else ""
            elif tag == "AC" and not key:
                key = line[2:].strip().rstrip(";").split(";")[0].strip().encode()
            elif tag in ("DE", "GN", "KW", "OS"):
                annot_lines.append(line[2:].strip())
            elif tag == "OX":
                txt = line[2:].strip()
                if "NCBI_TaxID=" in txt:
                    num = txt.split("NCBI_TaxID=")[1].split(";")[0].split()[0]
                    taxid = int("".join(ch for ch in num if ch.isdigit()) or 0)
            elif tag == "SQ":
                in_seq = True
            elif in_seq and line.startswith("  "):
                seq_lines.append(line.replace(" ", ""))
            elif tag == "//":
                in_seq = False
        if not key:
            key = entry_name.encode()
        seq = "".join(seq_lines)
        return key, {
            "sequence": pad_bytes(seq, self.seq_width),
            "length": np.asarray([len(seq)], np.int32),
            "annotation": pad_bytes(" | ".join(annot_lines), self.annot_width),
            "taxid": np.asarray([taxid], np.int32),
        }

    def format_entry(self, key: bytes, row: dict[str, np.ndarray]) -> str:
        """Emit the FASTA form used to build BLAST databases (the paper's
        `formatdb` input), not the full .dat round trip."""
        seq = unpad_bytes(row["sequence"]).decode()
        lines = [seq[i:i + 60] for i in range(0, len(seq), 60)] or [""]
        return f">{key.decode()}\n" + "\n".join(lines) + "\n"
