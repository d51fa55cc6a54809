"""FASTA parser (entries: `>id description\\nSEQUENCE...`)."""
from __future__ import annotations

import numpy as np

from .._schema_compat import FieldSchema
from ..plugins import FileParser
from ._text import pad_bytes, unpad_bytes


class FastaParser(FileParser):
    format_name = "fasta"

    def __init__(self, seq_width: int = 512, desc_width: int = 128):
        self.seq_width = seq_width
        self.desc_width = desc_width

    def entry_pattern(self):
        return (r"^>", r"(?=^>)|\Z")

    def schema(self):
        return [
            FieldSchema("sequence", self.seq_width, "int8"),
            FieldSchema("length", 1, "int32"),
            FieldSchema("desc", self.desc_width, "int8"),
        ]

    def split_entry(self, entry: str):
        header, _, body = entry.partition("\n")
        header = header.lstrip(">").strip()
        key, _, desc = header.partition(" ")
        seq = "".join(body.split())
        return key.encode(), {
            "sequence": pad_bytes(seq, self.seq_width),
            "length": np.asarray([len(seq)], np.int32),
            "desc": pad_bytes(desc, self.desc_width),
        }

    def format_entry(self, key: bytes, row: dict[str, np.ndarray]) -> str:
        desc = unpad_bytes(row["desc"]).decode()
        seq = unpad_bytes(row["sequence"]).decode()
        header = f">{key.decode()}" + (f" {desc}" if desc else "")
        lines = [seq[i:i + 60] for i in range(0, len(seq), 60)] or [""]
        return header + "\n" + "\n".join(lines) + "\n"
