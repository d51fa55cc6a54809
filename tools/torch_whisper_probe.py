#!/usr/bin/env python3
"""The whisper and tile slices of ``chip_smoke.py`` alone, on one card.

    python3 tools/torch_whisper_probe.py [--no-whisper] [--seed N]

Builds this checkout's kernels and runs, printing ``chip_smoke.py``'s JSON
lines:

* ``env``: the build, with each flash kernel's registers, spills and
  tensor-core instructions;
* ``kernel_edges_whisper``: flash forward and backward at whisper's
  heads (H 16 / K 16, D 64) and prompt lengths 4, 224 and 448, in bf16
  and f32, against the plain versions;
* unless ``--no-whisper``: the ``whisper`` phase (whisper-medium at its
  published widths served and trained, the f32 copy on the CPU and the
  card, a profiled prefill in a fresh process) and its kernel rows;
* ``tiles``: the route's and the keep mask's sweeps over the tiles each
  can launch, with a winner cache in a temporary directory under
  ``build/``.

Then the card's name and power limit. Exits non-zero on a failed check.
Needs a CUDA card; the quick loop for a change to whisper's model code
or to the kernels' tile resolution.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-whisper", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_whisper_probe.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, launch, ops as kops
    from repro_torch.launch import roofline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.phase_env(_build.build_all(), smi)
    bench = cs.KernelBench(kops, roofline, smi, cs.TIMED_REPS)
    cs.phase_kernel_edges_whisper(bench, args.seed)
    if not args.no_whisper:
        out = cs.phase_whisper(kops, args.seed)
        cs.phase_kernel_whisper(bench, out, args.seed)
        for name, n in out["launches"].items():
            print(cs.json.dumps(cs.kernel_row(name, bench.main[name], n)),
                  flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="whisper_probe_tiles_",
                            dir=os.path.join(ROOT, "build"))
    os.environ[launch.CACHE_ENV] = os.path.join(root, "tiles_torch.json")
    launch.reset_cache()
    try:
        cs.phase_tiles(bench, kops, args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
