#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs a CUDA card (it exits non-zero without one) and the CUDA toolkit's
nvcc; it builds the port's kernels from ``src/repro_torch/csrc`` into
``build/repro_torch/`` on first use. It prints one JSON object per line:

  env             card, power limit, torch/CUDA versions, kernel build time
  kernel          each CUDA kernel at ragged edge shapes, then at the main
                  path's own shapes: max |kernel - plain version| (must be
                  0), kernel / plain / library times, and its bound
  main_path       one store at UniProtKB/Swiss-Prot scale (570,000 entries,
                  sequence 64 x int32, length 1 x int32, annotation
                  8 x int32; 8 full releases at ts 10..80 with 3% sequence
                  churn, fresh annotation, 1% new and 0.1% deleted
                  entries): update, get_versions at Q = 1/8/64,
                  get_increments over the 7 release windows, a cold
                  get_version and compact(30), every row checked against
                  the release that produced it
  cpu_gpu_parity  a 2,000-entry history through device="cpu" and
                  device="cuda": identical views, increments and digests
  kernels         per kernel: launches during main_path, error, times,
                  bound

then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. Any mismatch or error ends the run with a
traceback, a non-zero exit and no ``ok`` line. Data comes from numpy
generators seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

N_ENTRIES = 570_000
SEQ_W, ANN_W = 64, 8
RELEASE_TS = [10, 20, 30, 40, 50, 60, 70, 80]
SEQ_CHURN, NEW_FRAC, DEL_FRAC = 0.03, 0.01, 0.001
COMPACT_TS = 30
PARITY_ENTRIES = 2_000
TIMED_REPS = 20  # back-to-back calls per kernel time
# kernel -> (its CUDA source, the TPU kernel of the JAX package it replaces)
SOURCES = {
    "fingerprint": ("src/repro_torch/csrc/fingerprint.cu",
                    "src/repro/kernels/fingerprint.py:29"),
    "masked_cumsum": ("src/repro_torch/csrc/masked_cumsum.cu",
                      "src/repro/kernels/batched_select.py:50 and "
                      "src/repro/kernels/version_select.py:30"),
    "keep_mask": ("src/repro_torch/csrc/keep_mask.cu",
                  "src/repro/kernels/compact_rewrite.py:35"),
}
INT32 = np.iinfo(np.int32)
DEV = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def wall(fn):
    """(result, host seconds) of ``fn`` run to completion on the card."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls (after one warm-up), by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_profile(fn) -> dict:
    """One run of ``fn`` under torch.profiler: host wall, summed device
    time of every kernel and copy, the device's idle share of the wall,
    and the largest device consumers (ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, s = wall(fn)
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same device time again
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3))
    rows.sort(key=lambda r: -r[1])
    dev_s = sum(ms for _, ms in rows) / 1e3
    return {"wall_s": s, "device_s": dev_s,
            "idle_share": 1 - dev_s / s if s > 0 else None,
            "top_ms": rows[:8]}


# ---------------------------------------------------------------------------
# synthetic UniProtKB/Swiss-Prot releases
# ---------------------------------------------------------------------------

def make_releases(n0: int, n_releases: int, seed: int) -> list[dict]:
    """Full releases: ``ids`` ascending entry numbers (key P%08d), and a
    table aligned with them. Each release after the first drops 0.1% of
    the entries at random, redraws the sequence of 3% of the rest, redraws
    every annotation, and appends 1% new entries."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n0, dtype=np.int64)
    table = {
        "sequence": rng.integers(0, 25, (n0, SEQ_W), dtype=np.int32),
        "length": rng.integers(50, 400, (n0, 1), dtype=np.int32),
        "annotation": rng.integers(0, 100, (n0, ANN_W), dtype=np.int32),
    }
    out = [{"ts": RELEASE_TS[0], "ids": ids, "table": table}]
    next_id = n0
    for ts in RELEASE_TS[1:n_releases]:
        n = len(ids)
        keep = np.ones(n, bool)
        keep[rng.choice(n, int(DEL_FRAC * n), replace=False)] = False
        ids = ids[keep]
        table = {k: v[keep].copy() for k, v in table.items()}
        m = len(ids)
        upd = rng.choice(m, int(SEQ_CHURN * m), replace=False)
        table["sequence"][upd] = rng.integers(0, 25, (len(upd), SEQ_W),
                                              dtype=np.int32)
        table["annotation"] = rng.integers(0, 100, (m, ANN_W), dtype=np.int32)
        n_new = int(NEW_FRAC * n)
        ids = np.concatenate([ids, np.arange(next_id, next_id + n_new)])
        next_id += n_new
        table = {
            "sequence": np.concatenate([table["sequence"], rng.integers(
                0, 25, (n_new, SEQ_W), dtype=np.int32)]),
            "length": np.concatenate([table["length"], rng.integers(
                50, 400, (n_new, 1), dtype=np.int32)]),
            "annotation": np.concatenate([table["annotation"], rng.integers(
                0, 100, (n_new, ANN_W), dtype=np.int32)]),
        }
        out.append({"ts": ts, "ids": ids, "table": table})
    return out


def keys_of(ids: np.ndarray) -> list[bytes]:
    return [b"P%08d" % i for i in ids.tolist()]


def ids_of(keys: list[bytes]) -> np.ndarray:
    """Entry numbers of ``P%08d`` keys, parsed without a Python loop."""
    if not keys:
        return np.zeros(0, np.int64)
    digits = np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), 9)
    return (digits[:, 1:].astype(np.int64) - 48) @ (10 ** np.arange(7, -1, -1))


def release_at(releases, t):
    """The newest release with ts <= t, or None."""
    live = [r for r in releases if r["ts"] <= t]
    return live[-1] if live else None


def check_view(view, releases, t, fields) -> None:
    """Every row of a materialized version equals the release it came
    from: same keys in row order, same values."""
    rel = release_at(releases, t)
    want_ids = np.zeros(0, np.int64) if rel is None else rel["ids"]
    check(view.ts == t, f"view ts {view.ts} != {t}")
    check(np.array_equal(ids_of(view.keys), want_ids),
          f"version {t}: keys differ from the release")
    for f in fields:
        got = view.values[f]
        want = (np.zeros((0, got.shape[1]), got.dtype) if rel is None
                else rel["table"][f])
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"version {t}: field {f} differs from the release")


def check_increment(inc, r0, r1) -> None:
    """new / updated / deleted sets of one window against its releases
    (significant field: sequence), values at t1, zeros for deleted."""
    ids0, ids1 = r0["ids"], r1["ids"]
    in1 = np.isin(ids0, ids1)
    new_ids = ids1[~np.isin(ids1, ids0)]
    del_ids = ids0[~in1]
    both = ids0[in1]
    i0 = np.searchsorted(ids0, both)
    i1 = np.searchsorted(ids1, both)
    seq_changed = (r0["table"]["sequence"][i0]
                   != r1["table"]["sequence"][i1]).any(axis=1)
    upd_ids = both[seq_changed]
    got = ids_of(inc.keys)
    want = np.sort(np.concatenate([new_ids, upd_ids, del_ids]))
    check(np.array_equal(got, want),
          f"increment ({inc.t0}, {inc.t1}]: entry set differs")
    kind = np.full(len(want), -1, np.int8)
    kind[np.isin(want, new_ids)] = 0
    kind[np.isin(want, upd_ids)] = 1
    kind[np.isin(want, del_ids)] = 2
    check(np.array_equal(inc.kind, kind),
          f"increment ({inc.t0}, {inc.t1}]: kinds differ")
    alive = kind != 2
    rows = np.searchsorted(ids1, got[alive])
    for f, vals in inc.values.items():
        check(np.array_equal(vals[alive], r1["table"][f][rows]),
              f"increment ({inc.t0}, {inc.t1}]: {f} values differ")
        check(not vals[~alive].any(),
              f"increment ({inc.t0}, {inc.t1}]: deleted rows not zero")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_env(build_info: dict, smi: str) -> None:
    emit({"phase": "env", "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_seconds": build_info["seconds"],
          "built": build_info["built"],
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in build_info["ptxas"].items()}})


class KernelBench:
    """Runs each kernel against its plain version and keeps the record of
    the main-path shape for the ``kernels`` line."""

    def __init__(self, kops, roofline, smi: str, reps: int):
        self.kops, self.roof, self.smi, self.reps = kops, roofline, smi, reps
        self.main: dict[str, dict] = {}

    def bound(self, nbytes: float, ops: float) -> tuple[float, str]:
        tb = nbytes / self.roof.HBM_BW
        to = ops / self.roof.PEAK_CUDA_CORE_OPS
        return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

    def run(self, name: str, shape: dict, kernel, plain, nbytes, ops,
            library=None, *, timed: bool, main: bool = False) -> None:
        got = kernel()
        want = plain()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {shape}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        bound_ms, bound_by = self.bound(nbytes, ops)
        rec = {"phase": "kernel", "name": name, "shape": shape,
               "max_abs_diff": err, "bound_ms": bound_ms,
               "bound_by": bound_by, "replaces": SOURCES[name][1],
               "gpu": self.smi}
        if timed:
            rec["kernel_ms"] = cuda_ms(kernel, self.reps)
            rec["plain_ms"] = cuda_ms(plain, self.reps)
            rec["library_ms"] = (cuda_ms(library, self.reps)
                                 if library is not None else None)
        emit(rec)
        check(err == 0, f"{name} {shape}: kernel differs from plain by {err}")
        if main:
            self.main[name] = rec

    # -- the three kernels --------------------------------------------------
    def fingerprint(self, lanes, *, timed=True, main=False):
        n, w = lanes.shape
        self.run("fingerprint", {"N": n, "W": w},
                 lambda: self.kops.fingerprint(lanes),
                 lambda: self.kops.ref.ref_fingerprint(lanes),
                 nbytes=n * w * 4 + n * 8, ops=5 * n * w + 4 * n,
                 timed=timed, main=main)

    def masked_cumsum(self, ts, tq, *, timed=True, main=False):
        (c,), (q,) = ts.shape, tq.shape
        mask = (ts[None, :] <= tq[:, None]).to(torch.int32)
        self.run("masked_cumsum", {"C": c, "Q": q},
                 lambda: self.kops.batched_masked_cumsum(ts, tq),
                 lambda: self.kops.ref.ref_batched_masked_cumsum(ts, tq),
                 nbytes=c * 4 + q * 4 + q * c * 4, ops=2 * q * c,
                 library=lambda: torch.cumsum(mask, dim=1, dtype=torch.int32),
                 timed=timed, main=main)

    def keep_mask(self, ts, cutoff, *, timed=True, main=False):
        (c,) = ts.shape
        tile = self.kops.launch.tile_for("keep_mask")
        n_tiles = -(-c // tile)
        self.run("keep_mask", {"C": c, "cutoff": cutoff},
                 lambda: self.kops.keep_mask(ts, cutoff),
                 lambda: self.kops.ref.ref_keep_mask(ts, cutoff, tile),
                 nbytes=8 * c + 4 * n_tiles, ops=2 * c,
                 timed=timed, main=main)


def phase_kernel_edges(bench: KernelBench, rng) -> None:
    """Ragged and extreme shapes, compared only (they time launch cost)."""
    dev = DEV
    for n in (1, 513):
        for w in (1, 8, 64):
            lanes = rng.integers(INT32.min, INT32.max, (n, w),
                                 dtype=np.int32, endpoint=True)
            lanes[0, 0] = INT32.min
            lanes[-1, -1] = INT32.max
            bench.fingerprint(torch.as_tensor(lanes, device=dev), timed=False)
    ts_max = 2**31 - 2
    for c in (1, 2047, 2049, 5001):
        for q in (1, 8, 64):
            ts = np.sort(rng.integers(-5, 97, c)).astype(np.int32)
            ts[-1] = ts_max
            tq = rng.integers(-10, 110, q).astype(np.int32)
            tq[0] = ts_max
            tq[-1] = -(2**31) + 1
            bench.masked_cumsum(torch.as_tensor(ts, device=dev),
                                torch.as_tensor(tq, device=dev), timed=False)
    for c in (1, 1023, 1025, 100_003):
        ts = rng.integers(-100, 100, c).astype(np.int32)
        for cutoff in (0, -(2**31) + 1, ts_max):
            bench.keep_mask(torch.as_tensor(ts, device=dev), cutoff,
                            timed=False)


def phase_main_path(VersionedStore, FieldSchema, kops, releases) -> dict:
    """The main path on one store at full width, checked row by row."""
    for fn in kops.KERNELS.values():
        fn.launches = 0
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32")]
    st = VersionedStore("uniprot_sprot", schema, capacity=N_ENTRIES)
    fields = [f.name for f in schema]
    rec = {"phase": "main_path", "entries": len(releases[0]["ids"]),
           "releases": len(releases), "update_s": []}
    prev = None
    for r in releases:
        keys = keys_of(r["ids"])
        info, s = wall(lambda: st.update(r["ts"], keys, r["table"]))
        rec["update_s"].append(s)
        if prev is None:
            want = (len(r["ids"]), 0, 0)
        else:
            both = np.isin(prev["ids"], r["ids"])
            i0 = np.nonzero(both)[0]
            i1 = np.searchsorted(r["ids"], prev["ids"][both])
            changed = np.zeros(len(i0), bool)
            for f in fields:
                changed |= (prev["table"][f][i0]
                            != r["table"][f][i1]).any(axis=1)
            want = (int((~np.isin(r["ids"], prev["ids"])).sum()),
                    int(changed.sum()), int((~both).sum()))
        check((info.n_new, info.n_updated, info.n_deleted) == want,
              f"release {r['ts']}: VersionInfo {info} != {want}")
        prev = r
    rec["entries_final"] = st.n_rows
    sl, rec["superlog_build_s"] = wall(st.superlog)
    rec["fused_cells"] = sl.n_cells
    _, rec["first_query_s"] = wall(lambda: st.get_versions([RELEASE_TS[-1]]))
    queries = {1: [RELEASE_TS[-1]], 8: RELEASE_TS,
               64: sorted(set(np.linspace(5, 85, 64).astype(int).tolist()))}
    check(len(queries[64]) == 64, "64 distinct query timestamps")
    rec["get_versions_s"], rec["get_versions_stages_s"] = {}, {}
    for q, tss in queries.items():
        stages = {}
        views, s = wall(lambda: st.get_versions(tss, trace=stages))
        rec["get_versions_s"][str(q)] = s
        rec["get_versions_stages_s"][str(q)] = stages
        for t, v in zip(tss, views):
            check_view(v, releases, t, fields)
        del views
    rec["profile_get_versions_64"] = device_profile(
        lambda: st.get_versions(queries[64]))
    pairs = list(zip(RELEASE_TS[:-1], RELEASE_TS[1:len(releases)]))
    incs, rec["get_increments_s"] = wall(
        lambda: st.get_increments(pairs, significant_fields=["sequence"]))
    for (t0, t1), inc in zip(pairs, incs):
        check_increment(inc, release_at(releases, t0),
                        release_at(releases, t1))
    rec["increment_sizes"] = [len(i) for i in incs]
    del incs
    rec["profile_get_increments"] = device_profile(
        lambda: st.get_increments(pairs, significant_fields=["sequence"]))
    scan_ts = sl.ts[: sl.n_cells].clone()  # the scan's input, for timing
    st.drop_superlog()
    view, rec["cold_get_version_s"] = wall(lambda: st.get_version(50))
    check_view(view, releases, 50, fields)
    # the largest log compact() masks, for timing
    compact_ts = max((c.log.csr(st.n_rows)[1] for c in st.fields.values()),
                     key=len).astype(np.int32)
    stats, rec["compact_s"] = wall(lambda: st.compact(COMPACT_TS))
    rec["compact"] = stats
    check(st.versions[0].ts == COMPACT_TS and stats["cells_dropped"] > 0,
          "compact did not fold the history")
    after = [t for t in RELEASE_TS if t >= COMPACT_TS] + [55, 85]
    for t, v in zip(after, st.get_versions(after)):
        check_view(v, releases, t, fields)
    rec["launches"] = {k: fn.launches for k, fn in kops.KERNELS.items()}
    emit(rec)
    for name, n in rec["launches"].items():
        check(n > 0, f"kernel {name} never launched on the main path")
    return {"launches": rec["launches"], "scan_ts": scan_ts,
            "compact_ts": compact_ts}


def phase_kernel_main(bench: KernelBench, kops, releases, main_out) -> None:
    """Each kernel at the shapes the main path gave it, timed: the first
    release's field tables (570,000 entries), the fused ts that
    get_versions scanned, and the largest log that compact() masked."""
    r = releases[0]
    for f in ("length", "annotation", "sequence"):
        lanes = kops.to_int_lanes(r["table"][f], DEV)
        bench.fingerprint(lanes, main=(f == "sequence"))
    for q in (1, 8, 64):
        tq = torch.as_tensor(np.linspace(5, 85, q).astype(np.int32),
                             device=DEV)
        bench.masked_cumsum(main_out["scan_ts"], tq, main=(q == 64))
    bench.keep_mask(torch.as_tensor(main_out["compact_ts"], device=DEV),
                    COMPACT_TS, main=True)


def phase_parity(VersionedStore, FieldSchema, seed: int) -> None:
    """The same small history through device="cpu" and device="cuda"."""
    releases = make_releases(PARITY_ENTRIES, len(RELEASE_TS), seed + 1)
    schema = [FieldSchema("sequence", SEQ_W, "int32"),
              FieldSchema("length", 1, "int32"),
              FieldSchema("annotation", ANN_W, "int32"),
              FieldSchema("flags", 2, "uint16")]
    stores = [VersionedStore("parity", schema, device=d)
              for d in ("cpu", DEV)]
    frng = np.random.default_rng(seed + 2)
    for r in releases:
        table = dict(r["table"])
        # near the top of uint16: sign-extended lanes, packed deltas
        table["flags"] = 65500 + frng.integers(0, 36, (len(r["ids"]), 2),
                                               dtype=np.uint16)
        for s in stores:
            s.update(r["ts"], keys_of(r["ids"]), table)
    stores[0].delete(85, keys_of(releases[-1]["ids"][:7]))
    stores[1].delete(85, keys_of(releases[-1]["ids"][:7]))

    def same(a, b, what):
        check(a.keys == b.keys, f"{what}: keys differ")
        for f in a.values:
            check(a.values[f].dtype == b.values[f].dtype
                  and np.array_equal(a.values[f].view(np.uint8),
                                     b.values[f].view(np.uint8)),
                  f"{what}: {f} differs")

    qs = [5, 10, 35, 80, 85, 2**31]
    pairs = [(10, 20), (-1, 50), (70, 85)]
    n_checked = 0
    for phase in ("cold", "warm", "compacted"):
        if phase == "warm":
            for s in stores:
                s.superlog()
        if phase == "compacted":
            for s in stores:
                s.compact(COMPACT_TS)
            qs = [30, 45, 80, 85]
        for q in qs:  # one ts at a time takes the cold path when not warm
            same(stores[0].get_version(q), stores[1].get_version(q),
                 f"{phase} get_version({q})")
        for a, b in zip(stores[0].get_versions(qs), stores[1].get_versions(qs)):
            same(a, b, f"{phase} get_versions")
        for a, b in zip(
                stores[0].get_increments(pairs, significant_fields=["sequence"]),
                stores[1].get_increments(pairs, significant_fields=["sequence"])):
            check(np.array_equal(a.kind, b.kind), f"{phase} increment kinds")
            same(a, b, f"{phase} get_increments")
        n_checked += len(qs) * 2 + len(pairs)
        check(stores[0]._version_digests == stores[1]._version_digests,
              f"{phase}: digests differ")
        check(stores[0].versions == stores[1].versions,
              f"{phase}: VersionInfo differs")
    emit({"phase": "cpu_gpu_parity", "entries": PARITY_ENTRIES,
          "releases": len(releases), "results_compared": n_checked,
          "digest": stores[1]._history_digest,
          "digests_equal": True})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated release and input")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke.py: no src/repro_torch beside {HERE}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.core import FieldSchema, VersionedStore
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.launch import roofline

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    phase_env(_build.build_all(), smi)
    rng = np.random.default_rng(args.seed)
    bench = KernelBench(kops, roofline, smi, TIMED_REPS)
    phase_kernel_edges(bench, rng)
    releases = make_releases(N_ENTRIES, len(RELEASE_TS), args.seed)
    main_out = phase_main_path(VersionedStore, FieldSchema, kops, releases)
    phase_kernel_main(bench, kops, releases, main_out)
    phase_parity(VersionedStore, FieldSchema, args.seed)
    rows = []
    for name, (source, replaces) in SOURCES.items():
        m = bench.main[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": main_out["launches"][name],
                     "max_abs_err": m["max_abs_diff"], "ms": m["kernel_ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "shape": m["shape"]})
    emit({"kernels": rows, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
