"""GeStore plugin framework (paper §III.F).

A tool plugin = (file parsers, file generator, output merger). The parser
interface mirrors the paper's six methods: entry delimiters, entry->columns
split, version compare, required-element validation, Put-object generation
(here: (key, field-row dict)), and output formatting. Plugins are small —
the framework owns storage, change detection, generation and merging.

The port's copy of ``repro.core.plugins``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Iterable, Sequence

import numpy as np

from .store import FieldSchema, Increment, VersionView


class FileParser(abc.ABC):
    """One parser per file format (§III.F.1). Subclasses are format-specific;
    everything tool-specific lives in the generator/merger."""

    #: format name (registry key)
    format_name: str = ""

    # (i) regular expressions delimiting an entry in the file
    @abc.abstractmethod
    def entry_pattern(self) -> tuple[str, str]:
        """(start_regex, end_regex) for one entry."""

    # (ii) split an entry into columns
    @abc.abstractmethod
    def split_entry(self, entry: str) -> tuple[bytes, dict[str, np.ndarray]]:
        """entry text -> (row key, field -> fixed-width row)."""

    # schema of the columns this parser emits
    @abc.abstractmethod
    def schema(self) -> list[FieldSchema]:
        ...

    # (iii) compare two versions of an entry (fingerprint equality on fields)
    def compare(self, a: dict[str, np.ndarray], b: dict[str, np.ndarray],
                significant: Sequence[str] | None = None) -> bool:
        names = significant if significant is not None else list(a)
        return all(np.array_equal(a[n], b[n]) for n in names)

    # (iv) check an entry contains every element the tool needs
    def validate(self, row: dict[str, np.ndarray],
                 required: Sequence[str]) -> bool:
        return all(n in row and np.asarray(row[n]).size > 0 for n in required)

    # (v) generate a Put object (key + column dict, HBase Put analogue)
    def to_put(self, entry: str) -> tuple[bytes, dict[str, np.ndarray]]:
        return self.split_entry(entry)

    # (vi) generate output in other formats
    @abc.abstractmethod
    def format_entry(self, key: bytes, row: dict[str, np.ndarray]) -> str:
        """row -> file text (inverse of split_entry up to canonicalization)."""

    # -- framework-provided bulk helpers (plugins get these for free) --------
    def parse_text(self, text: str) -> tuple[list[bytes], dict[str, np.ndarray]]:
        # routed through the streaming path so whole-file and chunked
        # parses share one implementation (byte-identity by construction)
        keys, rows = [], []
        for k, r in self.iter_records([text]):
            keys.append(k)
            rows.append(r)
        if not rows:
            return [], self.empty_table()
        return keys, self.stack_rows(rows)

    def iter_entries(self, text: str) -> Iterable[str]:
        return self.iter_entries_chunks([text])

    def iter_entries_chunks(self, chunks: Iterable[str]) -> Iterable[str]:
        """Split a release streamed as arbitrary text chunks into entries.

        Yields the same entry strings ``iter_entries`` produces on the
        concatenated text, without ever materialising the whole release:
        only the current entry and one partial line are buffered. Start
        regexes are line-anchored (``^...``) and must be decidable within
        a line plus its terminating newline — true of every shipped
        parser. Text before the first entry start is dropped and a
        truncated final record is still yielded, both exactly as in the
        whole-file split.
        """
        for entry, _ in self.iter_entries_with_offsets(chunks):
            yield entry

    def iter_entries_with_offsets(
            self, chunks: Iterable[str],
    ) -> Iterable[tuple[str, int]]:
        """``(entry, end_offset)`` pairs from streamed chunks.

        ``end_offset`` is the absolute character offset one past the
        entry's last character — equivalently, the offset the *next*
        entry starts at. A stream re-opened at that offset parses the
        remaining entries identically (the resumable-ingest seek point;
        character == byte for the ASCII release formats).
        """
        import re
        start_re, _ = self.entry_pattern()
        rx = re.compile(start_re, re.M)
        buf = ""          # from the current entry's start (or stream junk)
        base = 0          # absolute offset of buf[0]
        started = False   # buf[0] is a real entry start
        for chunk in chunks:
            if not chunk:
                continue
            buf += chunk
            # only complete lines are decidable: a start pattern must be
            # resolvable within a line + its newline (the parser contract),
            # so matching stops at the last newline and the partial final
            # line carries over to the next chunk
            cut = buf.rfind("\n") + 1
            if not cut:
                continue
            # C-speed scan; pos=1 skips buf[0] when it is the (already
            # known) current entry's start, and ``^`` still anchors to
            # true line boundaries regardless of pos
            starts = [m.start()
                      for m in rx.finditer(buf, 1 if started else 0, cut)]
            if started:
                starts.insert(0, 0)
            if not starts:
                # no entry yet: everything decidable is droppable prefix
                base += cut
                buf = buf[cut:]
                continue
            for i in range(len(starts) - 1):
                yield buf[starts[i]:starts[i + 1]], base + starts[i + 1]
            base += starts[-1]
            buf = buf[starts[-1]:]
            started = True
        if buf:
            # EOF terminates the final (possibly newline-less) line, so
            # the held-back tail becomes decidable: split any entry
            # starts in it exactly as the whole-file finditer would
            starts = [m.start()
                      for m in rx.finditer(buf, 1 if started else 0)]
            if started:
                starts.insert(0, 0)
            for i in range(len(starts) - 1):
                yield buf[starts[i]:starts[i + 1]], base + starts[i + 1]
            if starts:
                yield buf[starts[-1]:], base + len(buf)

    def iter_records(
            self, chunks: Iterable[str],
    ) -> Iterable[tuple[bytes, dict[str, np.ndarray]]]:
        """(key, field->row) records from streamed text chunks. Block
        formats whose ``split_entry`` is undefined override this."""
        for entry in self.iter_entries_chunks(chunks):
            yield self.split_entry(entry)

    def parse_chunks(
            self, chunks: Iterable[str], batch_entries: int = 512,
    ) -> Iterable[tuple[list[bytes], dict[str, np.ndarray]]]:
        """Stream text chunks into ``(keys, table)`` batches of at most
        ``batch_entries`` rows — the bounded-memory ingest feed."""
        keys: list[bytes] = []
        rows: list[dict[str, np.ndarray]] = []
        for k, r in self.iter_records(chunks):
            keys.append(k)
            rows.append(r)
            if len(keys) >= batch_entries:
                yield keys, self.stack_rows(rows)
                keys, rows = [], []
        if keys:
            yield keys, self.stack_rows(rows)

    def stack_rows(
            self, rows: Sequence[dict[str, np.ndarray]],
    ) -> dict[str, np.ndarray]:
        return {name: np.stack([r[name] for r in rows]) for name in rows[0]}

    def empty_table(self) -> dict[str, np.ndarray]:
        return {f.name: np.zeros((0, f.width), f.np_dtype)
                for f in self.schema()}

    def format_view(self, view: VersionView | Increment) -> str:
        out = []
        for i, k in enumerate(view.keys):
            row = {n: v[i] for n, v in view.values.items()}
            out.append(self.format_entry(k, row))
        return "".join(out)


@dataclasses.dataclass
class FileGenerator:
    """Tool-specific input/meta-data file generation (§III.F.2): which parser
    per file, which fields the tool reads, which fields are significant for
    change detection (the BLAST lesson: annotation edits don't change
    alignments)."""
    parser: str                      # format registry key
    output_fields: Sequence[str]     # fields written to the generated file
    significant_fields: Sequence[str]  # fields that trigger an increment
    required_fields: Sequence[str] = ()


class OutputMerger(abc.ABC):
    """Tool-specific incremental-output merge (§III.F.3)."""

    @abc.abstractmethod
    def merge(self, previous: str, partial: str, *, context: dict) -> str:
        """Merge a partial (incremental) tool output into the previous full
        output, fixing aggregate fields (e.g. BLAST e-values).

        Args:
          previous: the full output of the last run against the old
            version.
          partial: the tool's output against the increment only.
          context: `GeneratedInput.context` — changed-key sets
            (``deleted_keys`` / ``updated_keys`` / ``new_keys``), db-size
            fields when applicable, and the tool's params.

        Returns:
          Full output text equivalent to rerunning against the new
          version.
        """


@dataclasses.dataclass
class ToolPlugin:
    """One unmodified tool's plugin bundle (§III.F): its file generator,
    optional output merger, and free-form params. ``params`` is recorded
    into cache descriptors, so two configurations of the same tool never
    share generated files."""
    name: str
    generator: FileGenerator
    merger: OutputMerger | None = None
    #: extra free-form parameters recorded into cache descriptors
    params: dict = dataclasses.field(default_factory=dict)


class PluginRegistry:
    """Registry mapping format names -> parsers and tool names -> plugins.
    ``REGISTRY`` is the module-level default; GeStore takes any instance."""

    def __init__(self):
        self.parsers: dict[str, FileParser] = {}
        self.tools: dict[str, ToolPlugin] = {}

    def register_parser(self, parser: FileParser) -> FileParser:
        """Register (and return) a parser under its ``format_name``.
        Raises AssertionError when the parser has no format name."""
        assert parser.format_name, "parser needs format_name"
        self.parsers[parser.format_name] = parser
        return parser

    def register_tool(self, plugin: ToolPlugin) -> ToolPlugin:
        """Register (and return) a tool plugin under its name."""
        self.tools[plugin.name] = plugin
        return plugin

    def parser_for(self, tool: str) -> FileParser:
        """The parser a registered tool generates files with.
        Raises KeyError for an unknown tool or unregistered format."""
        return self.parsers[self.tools[tool].generator.parser]


REGISTRY = PluginRegistry()
