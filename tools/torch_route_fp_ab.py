#!/usr/bin/env python3
"""Time the port's fingerprint and key route in two checkouts on one card,
in turns.

    python3 tools/torch_route_fp_ab.py PARENT_DIR [CHANGE_DIR] [--rounds N]

From PARENT_DIR and CHANGE_DIR (default: this checkout), in the order
parent, change, change, parent, N times (default 1), each in a process of
its own that builds its checkout's store kernels first, on
``chip_smoke.py``'s synthetic UniProtKB/Swiss-Prot releases (seed 0):

* the fingerprint of the first release's three fields (W 64 / 8 / 1 at
  N 570,000): the card's time per call alone (calls queued behind a spin
  kernel) and per call (20 back-to-back calls, host time included);
* ``route_keys`` of the last release's keys over 4 shards, three times;
* the releases into a 4-shard ``ShardedStore`` as ``chip_smoke.py``'s
  sharding phase ingests them (ts 10..40 by ``update``, ts 50..80 by
  threaded ``ShardedReleaseSession`` waves of 4 chunks), with no queries.

Prints one JSON line per process. Needs a CUDA card; both checkouts must
hold ``chip_smoke.py`` and ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import numpy as np
import chip_smoke as cs
from repro_torch import core
from repro_torch.kernels import _build, ops as kops
# the store's kernels (no path timed here launches flash attention)
_build.SOURCES = tuple(s for s in _build.SOURCES if s != "flash_attention")
_build.build_all()
releases = cs.make_releases(cs.N_ENTRIES, len(cs.RELEASE_TS), 0)
rec = {}
for f in ("sequence", "annotation", "length"):
    lanes = kops.to_int_lanes(releases[0]["table"][f], "cuda")
    call = lambda: kops.fingerprint(lanes)
    rec[f"fingerprint_W{lanes.shape[1]}"] = {
        "device_ms": cs.queued_ms(call, cs.TIMED_REPS),
        "call_ms": cs.cuda_ms(call, cs.TIMED_REPS)}
    del lanes
keys = cs.keys_of(releases[-1]["ids"])
rec["route_keys_s"] = [cs.wall(lambda: kops.route_keys(
    keys, cs.N_SHARDS, "cuda"))[1] for _ in range(3)]
schema = [core.FieldSchema("sequence", cs.SEQ_W, "int32"),
          core.FieldSchema("length", 1, "int32"),
          core.FieldSchema("annotation", cs.ANN_W, "int32")]
st = core.ShardedStore("uniprot_sprot", schema, n_shards=cs.N_SHARDS,
                       capacity=cs.N_ENTRIES)
rec["update_s"], rec["session_apply_s"], rec["session_finish_s"] = [], [], []
for r in releases:
    keys = cs.keys_of(r["ids"])
    if r["ts"] <= 40:
        rec["update_s"].append(cs.wall(
            lambda: st.update(r["ts"], keys, r["table"]))[1])
        continue
    sess = st.begin_release(r["ts"], parallel=True)
    applies = []
    for part in np.array_split(np.arange(len(keys)), 4):
        chunk = [keys[i] for i in part]
        table = {f: v[part] for f, v in r["table"].items()}
        applies.append(cs.wall(lambda: sess.apply(chunk, table))[1])
    rec["session_apply_s"].append(applies)
    rec["session_finish_s"].append(cs.wall(sess.finish)[1])
print("AB " + json.dumps(rec), flush=True)
"""


def run(root: str) -> dict:
    """The record of one child process on ``root``."""
    out = subprocess.run([sys.executable, "-c", CHILD, root],
                         capture_output=True, text=True, cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("AB "):
            return json.loads(line[3:])
    raise RuntimeError(f"{root}: no record")


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
            print(json.dumps({"tree": tag, **run(trees[tag])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
