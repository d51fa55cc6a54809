"""Carrying a store across: its logs and history as plain values.

``to_state(store)`` returns a dict of plain Python and numpy values;
``from_state(cls, state, device=...)`` rebuilds a store from it, on any
device. The arrays are what a JAX-package store holds too (each log's
consolidated CSR and the release history), so a test can read them out
of a ``repro`` store and hand them to the port; head state is not carried
but rebuilt lazily on the first mutation, as after the JAX package's
``load``. This is the in-memory route between the packages; the on-disk
route is a store directory (``save``/``load``, core/segments.py).

State layout::

    {"name": str,
     "schema": [{"name": str, "width": int, "dtype": str}, ...],
     "row_keys": [bytes, ...],                    # row i's key
     "logs": {field name or "__exists__":
              {"vals": (C, W), "ts": (C,) int64, "rows": (C,) int32,
               "ptr": (n_rows + 1,) int32}},       # CSR sorted by (row, ts)
     "versions": [VersionInfo fields as dicts],
     "version_digests": [str, ...],
     "history_digest": str}
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

EXISTS = "__exists__"


def to_state(store) -> dict:
    """The store's schema, keys, consolidated logs and history."""
    logs = {}
    named = [(n, c.log) for n, c in store.fields.items()]
    for name, log in named + [(EXISTS, store.exists_log)]:
        vals, tss, ptr = log.csr(store.n_rows)
        logs[name] = {"vals": vals, "ts": tss, "rows": log._csr[2],
                      "ptr": np.asarray(ptr, np.int32)}
    return {
        "name": store.name,
        "schema": [dataclasses.asdict(fs) for fs in store.schema.values()],
        "row_keys": list(store.row_keys),
        "logs": logs,
        "versions": [dataclasses.asdict(v) for v in store.versions],
        "version_digests": list(store._version_digests),
        "history_digest": store._history_digest,
    }


def from_state(cls, state: Mapping, *, device=None):
    """A ``cls`` store holding ``state``'s logs and history on ``device``."""
    from .store import FieldSchema, VersionInfo
    n_rows = len(state["row_keys"])
    st = cls(state["name"], [FieldSchema(**f) for f in state["schema"]],
             capacity=max(16, n_rows), device=device)
    st.n_rows = n_rows
    st.row_keys = [bytes(k) for k in state["row_keys"]]
    st.key_to_row = {k: i for i, k in enumerate(st.row_keys)}
    logs = {n: c.log for n, c in st.fields.items()}
    logs[EXISTS] = st.exists_log
    if set(state["logs"]) != set(logs):
        raise ValueError(f"state logs {sorted(state['logs'])} do not match "
                         f"the schema's {sorted(logs)}")
    for name, log in logs.items():
        s = state["logs"][name]
        vals = np.ascontiguousarray(s["vals"], dtype=log.dtype).reshape(
            -1, log.width)
        ptr = np.asarray(s["ptr"], np.int32)
        if len(ptr) != n_rows + 1 or int(ptr[-1]) != len(vals):
            raise ValueError(f"log {name}: CSR pointers do not match "
                             f"{n_rows} rows and {len(vals)} cells")
        log.splice_csr(vals, np.asarray(s["ts"], np.int64),
                       np.asarray(s["rows"], np.int32), ptr, n_rows)
    st.versions = [VersionInfo(**v) for v in state["versions"]]
    st._version_digests = list(state["version_digests"])
    st._history_digest = state["history_digest"]
    st.mark_heads_stale()
    st._invalidate_log()
    return st
