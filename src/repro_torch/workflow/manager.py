"""Mini workflow manager (the paper's GePan, §II.B.1 + §IV.C).

A workflow is a DAG of Tools; each Tool is an UNMODIFIED callable from
input file paths to an output string. The manager integrates GeStore the
way the paper's 300-LOC GePan patch does: before a tool runs, file-copy
operations are replaced by `gestore.generate_files` (full version,
increment, or cache hit); after it runs, `gestore.merge_files` folds the
partial output into previous results. Provenance lands in the `runs` table;
users may pin a meta-database version per run (§IV.D) and pass an entry
filter (the taxon use case).

The port's copy of ``repro.workflow.manager``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..core.increment import GeStore


@dataclasses.dataclass
class Tool:
    name: str
    fn: Callable[[dict], str]        # {input name -> path or text} -> output text
    inputs: list[str]                # names: either prior tool names or "store:<db>"
    uses_increments: bool = True


@dataclasses.dataclass
class WorkflowResult:
    outputs: dict[str, str]
    mode: str
    wall_s: float
    generated: dict[str, str]        # input name -> generation mode used


class WorkflowManager:
    def __init__(self, gestore: GeStore, tools: list[Tool]):
        self.gs = gestore
        self.tools = {t.name: t for t in tools}
        self.order = self._toposort(tools)
        self.previous_outputs: dict[str, str] = {}

    def _toposort(self, tools: list[Tool]) -> list[str]:
        names = {t.name for t in tools}
        done: list[str] = []
        while len(done) < len(tools):
            progressed = False
            for t in tools:
                if t.name in done:
                    continue
                deps = [i for i in t.inputs if i in names]
                if all(d in done for d in deps):
                    done.append(t.name)
                    progressed = True
            assert progressed, "workflow DAG has a cycle"
        return done

    def ingest_release(self, store_name: str, ts: int, source, *,
                       parser_name: str, label: str = "",
                       full_release: bool = True, shards: int = 1,
                       config=None, pressure_fn=None):
        """Run a streaming release ingest as a journaled workflow step.

        The data-feeder analogue of ``run()``: the ingest goes through
        ``GeStore.add_release_stream`` (chunk-parallel parse, shard-wave
        updates, resumable chunk journal under the GeStore root) and its
        provenance lands in the ``runs`` table — a crashed ingest leaves
        an unfinished run row plus the journal; re-invoking with the same
        arguments records a fresh run that replays journaled chunks and
        finishes the release.

        Returns:
          ``IngestReport`` from ``core.ingest``.
        """
        src_desc = source if isinstance(source, str) else f"<{type(source).__name__}>"
        run_id = f"ingest:{store_name}@{ts}-{time.time_ns()}"
        self.gs.tables.start_run(run_id, f"ingest:{store_name}", [src_desc],
                                 {"ts": int(ts), "label": label,
                                  "parser": parser_name,
                                  "full_release": bool(full_release)})
        rep = self.gs.add_release_stream(
            store_name, ts, source, parser_name=parser_name, label=label,
            full_release=full_release, shards=shards, config=config,
            pressure_fn=pressure_fn)
        self.gs.tables.finish_run(run_id, [
            f"store:{store_name}@{ts}",
            f"entries={rep.n_entries}",
            f"chunks_replayed={rep.chunks_replayed}",
            f"already_committed={rep.already_committed}"])
        return rep

    def run(self, *, db_version: int, last_version: int | None = None,
            key_filter: str | None = None) -> WorkflowResult:
        """last_version=None: full run at db_version (pinned-version use
        case). Otherwise an incremental rerun over (last_version, db_version]
        with per-tool output merging."""
        t0 = time.time()
        outputs: dict[str, str] = {}
        generated: dict[str, str] = {}
        for name in self.order:
            tool = self.tools[name]
            args: dict[str, str] = {}
            ctx: dict = {}
            for inp in tool.inputs:
                if inp.startswith("store:"):
                    db = inp.split(":", 1)[1]
                    t_last = last_version if tool.uses_increments else None
                    gen = self.gs.generate_files(
                        name, db, t_version=db_version, t_last=t_last,
                        key_filter=key_filter)
                    args[inp] = gen.path
                    ctx = gen.context
                    generated[f"{name}/{inp}"] = gen.mode
                else:
                    args[inp] = outputs[inp]
            run_id = f"{name}@{db_version}-{time.time_ns()}"
            self.gs.tables.start_run(run_id, name, list(args.values()),
                                     {"db_version": db_version,
                                      "last": last_version})
            partial = tool.fn(args)
            if last_version is not None and name in self.previous_outputs:
                partial = self.gs.merge_files(
                    name, self.previous_outputs[name], partial, context=ctx)
            outputs[name] = partial
            self.gs.tables.finish_run(run_id, [name])
        self.previous_outputs = dict(outputs)
        return WorkflowResult(outputs=outputs,
                              mode="full" if last_version is None else "incremental",
                              wall_s=time.time() - t0, generated=generated)
