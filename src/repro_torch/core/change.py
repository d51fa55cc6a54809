"""Tool-specific change detection helpers (paper §III.A).

The store's fingerprint comparison is field-granular; this module adds the
tool view: a SignificanceProfile names the fields whose changes matter to a
given tool, and classify() maps an Increment to per-kind key lists for merge
contexts. Coarse-grained (whole-file) detection is the degenerate profile
covering every field.

The port's copy of ``repro.core.change``.
"""
from __future__ import annotations

import dataclasses

from .store import Increment, KIND_DELETED, KIND_NEW, KIND_UPDATED


@dataclasses.dataclass(frozen=True)
class SignificanceProfile:
    tool: str
    fields: tuple[str, ...]          # significant fields
    handles_deletes: bool = True     # must deletions be propagated to merge?


def classify(inc: Increment) -> dict[str, list[bytes]]:
    out = {"new": [], "updated": [], "deleted": []}
    for key, kind in zip(inc.keys, inc.kind):
        if kind == KIND_NEW:
            out["new"].append(key)
        elif kind == KIND_UPDATED:
            out["updated"].append(key)
        elif kind == KIND_DELETED:
            out["deleted"].append(key)
    return out


# canonical profiles for the Meta-pipe tools (paper §IV.B)
BLASTP = SignificanceProfile("blastp", ("sequence", "length"))
MGA = SignificanceProfile("mga", ("sequence", "length"), handles_deletes=True)
