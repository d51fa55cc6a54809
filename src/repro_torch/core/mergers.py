"""Output mergers (paper §III.F.3, §IV.B).

The BLAST merger is the paper's worked example: e-values are normalized by
total database size, so results computed against an increment (or against an
older release) carry wrong e-values. Merge = rescale both sides to the new
database size, drop hits whose subject was deleted, union, and keep the best
hits per query. E = K*m*n*exp(-lambda*S) -> E' = E * m_new/m_old, i.e.
log10 E' = log10 E + log10(m_new/m_old) (cf. Turcu et al., the paper's [23]).

The port's copy of ``repro.core.mergers``.
"""
from __future__ import annotations

from collections import defaultdict

from .plugins import OutputMerger
from .parsers.blast_tab import BlastTabParser


class AppendMerger(OutputMerger):
    """For tools whose outputs are record-local (e.g. MGA gene calls):
    incremental output rows simply replace/extend previous rows."""

    def merge(self, previous: str, partial: str, *, context: dict) -> str:
        deleted = set(context.get("deleted_keys", ()))
        updated_first = {ln.split("\t", 1)[0].split("|", 1)[0]
                         for ln in partial.splitlines()
                         if ln and not ln.startswith("#")}
        keep = []
        for ln in previous.splitlines():
            if not ln or ln.startswith("#"):
                continue
            rec = ln.split("\t", 1)[0].split("|", 1)[0]
            if rec in deleted or rec in updated_first:
                continue
            keep.append(ln)
        out = keep + [ln for ln in partial.splitlines()
                      if ln and not ln.startswith("#")]
        return "\n".join(out) + ("\n" if out else "")


class BlastEvalueMerger(OutputMerger):
    """Merge incremental BLAST tabular output with previous results.

    context:
      db_size_old / db_size_new: total residues in old/new database
      deleted_keys: subject ids removed from the database
      updated_keys: subject ids recomputed in the increment (old hits against
        them are stale and dropped; the partial output has the fresh hits)
      max_hits_per_query: keep best-k per query after merge
    """

    def __init__(self):
        self.parser = BlastTabParser()

    def merge(self, previous: str, partial: str, *, context: dict) -> str:
        import math
        m_old = float(context["db_size_old"])
        m_new = float(context["db_size_new"])
        scale = math.log10(m_new / m_old) if m_old > 0 else 0.0
        deleted = {k.decode() if isinstance(k, bytes) else k
                   for k in context.get("deleted_keys", ())}
        updated = {k.decode() if isinstance(k, bytes) else k
                   for k in context.get("updated_keys", ())}
        max_hits = int(context.get("max_hits_per_query", 25))

        per_query: dict[str, list[tuple[float, str]]] = defaultdict(list)

        def add_lines(text: str, rescale: float):
            for ln in text.splitlines():
                if not ln.strip() or ln.startswith("#"):
                    continue
                cols = ln.split("\t")
                q, s, ev = cols[0], cols[1], float(cols[10])
                if rescale and s in (deleted | updated):
                    continue  # stale hit: subject changed or removed
                log_ev = (math.log10(ev) if ev > 0 else -400.0) + \
                    (scale if rescale else 0.0)
                cols[10] = f"{10 ** log_ev:.2e}"
                per_query[q].append((log_ev, "\t".join(cols)))

        add_lines(previous, rescale=True)   # old hits -> rescale e-values
        add_lines(partial, rescale=False)   # fresh hits already at m_new
        out_lines = []
        for q in sorted(per_query):
            hits = sorted(per_query[q], key=lambda t: t[0])[:max_hits]
            out_lines.extend(h[1] for h in hits)
        return "\n".join(out_lines) + ("\n" if out_lines else "")
