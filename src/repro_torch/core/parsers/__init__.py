"""Format parsers for the Meta-pipe file formats (paper §IV.B): FASTA,
UniProtKB flat-file, BLAST tabular output, and MGA output. One parser per
format, reused by every tool plugin that touches the format.

The port's copies of ``repro.core.parsers``.
"""
from .fasta import FastaParser
from .uniprot import UniProtParser
from .blast_tab import BlastTabParser
from .mga import MgaParser

__all__ = ["FastaParser", "UniProtParser", "BlastTabParser", "MgaParser"]
