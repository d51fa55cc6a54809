"""GeStore system tables (paper §III.D): `updates`, `runs`, `files`.

The paper keeps these as three HBase tables; here they are lightweight
host-side tables with JSON persistence. `updates` records every ingested
release per store; `runs` records which files each workflow tool execution
read/wrote (provenance); `files` indexes generated/materialized files for
cache lookup and for deciding HBase-vs-HDFS residency.

The port's copy of ``repro.core.tables``: the same rows and JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any


@dataclasses.dataclass
class UpdateRow:
    store: str
    ts: int
    label: str
    n_entries: int
    n_new: int = 0
    n_updated: int = 0
    n_deleted: int = 0


@dataclasses.dataclass
class RunRow:
    run_id: str
    tool: str
    inputs: list[str]
    outputs: list[str]
    params: dict[str, Any]
    wall_start: float
    wall_end: float = 0.0
    status: str = "running"


@dataclasses.dataclass
class FileRow:
    file_id: str        # canonical descriptor (filename-encoded, §III.E)
    path: str           # cache path ("HDFS") or "" if generatable from store
    plugin: str
    in_store: bool      # True: regenerable from HBase; False: unparsed blob
    bytes: int = 0
    created: float = 0.0
    last_used: float = 0.0


class SystemTables:
    def __init__(self, root: str | None = None):
        self.root = root
        self.updates: list[UpdateRow] = []
        self.runs: dict[str, RunRow] = {}
        self.files: dict[str, FileRow] = {}
        if root:
            os.makedirs(root, exist_ok=True)
            self._load()

    # -- updates -------------------------------------------------------------
    def record_update(self, store: str, info) -> None:
        self.updates.append(UpdateRow(store, info.ts, info.label, info.n_entries,
                                      info.n_new, info.n_updated, info.n_deleted))
        self._save()

    def updates_for(self, store: str) -> list[UpdateRow]:
        return [u for u in self.updates if u.store == store]

    # -- runs (provenance) -----------------------------------------------------
    def start_run(self, run_id: str, tool: str, inputs: list[str],
                  params: dict[str, Any] | None = None) -> RunRow:
        row = RunRow(run_id, tool, list(inputs), [], params or {}, time.time())
        self.runs[run_id] = row
        self._save()
        return row

    def finish_run(self, run_id: str, outputs: list[str], status: str = "done") -> None:
        row = self.runs[run_id]
        row.outputs = list(outputs)
        row.wall_end = time.time()
        row.status = status
        self._save()

    # -- files (cache index) ---------------------------------------------------
    def record_file(self, file_id: str, path: str, plugin: str, in_store: bool,
                    nbytes: int = 0) -> None:
        now = time.time()
        self.files[file_id] = FileRow(file_id, path, plugin, in_store, nbytes,
                                      created=now, last_used=now)
        self._save()

    def lookup_file(self, file_id: str) -> FileRow | None:
        row = self.files.get(file_id)
        if row is not None:
            row.last_used = time.time()
        return row

    def drop_file(self, file_id: str) -> None:
        self.files.pop(file_id, None)
        self._save()

    # -- persistence -----------------------------------------------------------
    def _save(self) -> None:
        if not self.root:
            return
        blob = {
            "updates": [dataclasses.asdict(u) for u in self.updates],
            "runs": {k: dataclasses.asdict(v) for k, v in self.runs.items()},
            "files": {k: dataclasses.asdict(v) for k, v in self.files.items()},
        }
        tmp = os.path.join(self.root, "tables.json.tmp")
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, os.path.join(self.root, "tables.json"))

    def _load(self) -> None:
        p = os.path.join(self.root, "tables.json")
        if not os.path.exists(p):
            return
        with open(p) as f:
            blob = json.load(f)
        self.updates = [UpdateRow(**u) for u in blob["updates"]]
        self.runs = {k: RunRow(**v) for k, v in blob["runs"].items()}
        self.files = {k: FileRow(**v) for k, v in blob["files"].items()}
