#!/usr/bin/env python3
"""Time the PyTorch port's main path in two checkouts on one card, in turns.

    python3 tools/torch_main_path_ab.py PARENT_DIR [CHANGE_DIR] [--rounds N]

Runs ``chip_smoke.py``'s main-path phase (one store at UniProtKB/Swiss-Prot
scale, 8 releases, get_versions at Q = 1/8/64, get_increments, compact)
from PARENT_DIR and CHANGE_DIR (default: this checkout) in the order
parent, change, change, parent, N times (default 1), each in a process of
its own that builds its checkout's kernels first. Prints one JSON line per
process with the tree, its get_versions walls and stages, and its Q = 64
profile (device time, idle share, top device consumers). Needs a CUDA
card; both checkouts must hold ``chip_smoke.py`` and ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.core import FieldSchema, VersionedStore
from repro_torch.kernels import _build, ops as kops
_build.build_all()
releases = cs.make_releases(cs.N_ENTRIES, len(cs.RELEASE_TS), 0)
cs.phase_main_path(VersionedStore, FieldSchema, kops, releases)
"""
KEYS = ("get_versions_s", "get_versions_stages_s", "update_s",
        "first_query_s", "get_increments_s", "cold_get_version_s",
        "compact_s")


def main_path(root: str) -> dict:
    """The main_path line of one run of ``root``'s chip_smoke.py."""
    out = subprocess.run([sys.executable, "-c", CHILD, root],
                         capture_output=True, text=True, cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("{") and '"main_path"' in line:
            return json.loads(line)
    raise RuntimeError(f"{root}: no main_path line")


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=here)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    for _ in range(args.rounds):
        for tag in ("parent", "change", "change", "parent"):
            rec = main_path(trees[tag])
            prof = rec["profile_get_versions_64"]
            print(json.dumps({"tree": tag, **{k: rec[k] for k in KEYS},
                              "profile_get_versions_64": {
                                  "wall_s": prof["wall_s"],
                                  "device_s": prof["device_s"],
                                  "idle_share": prof["idle_share"],
                                  "top_ms": prof["top_ms"][:4]}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
