#!/usr/bin/env python3
"""The model families' slice of ``chip_smoke.py`` alone, on one card.

    python3 tools/torch_families_probe.py [--no-families] [--seed N]

Builds this checkout's kernels and runs, printing ``chip_smoke.py``'s JSON
lines:

* ``env``: the build, with each flash kernel's registers and spills and
  its tensor-core instructions (the D 8 and D 112 instantiations among
  them);
* ``kernel_edges_serving``: flash attention at the edge shapes (D 8 and
  112 among them) in both dtypes against its plain version, and the
  masked merge's edges;
* unless ``--no-families``: the ``families`` phase (Jamba-v0.1 at its
  published widths through the Scheduler, the other new configs one
  bucket each, the smoke configs in f32 on the CPU and the card) and its
  kernel rows (flash at D 128 on Jamba's 4,096-token prefill, D 112 at
  kimi-k2's attention, D 8 at qwen2-0.5b-smoke's shape), each against its
  plain version and SDPA.

Then the card's name and power limit. Exits non-zero on a failed check.
Needs a CUDA card; the quick loop for a change to this slice's kernels or
model code.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-families", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_families_probe.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.launch import roofline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.phase_env(_build.build_all(), smi)
    bench = cs.KernelBench(kops, roofline, smi, cs.TIMED_REPS)
    cs.phase_kernel_edges_serving(bench, np.random.default_rng(args.seed))
    if not args.no_families:
        out = cs.phase_families(kops, args.seed)
        cs.phase_kernel_families(bench, out, args.seed)
        for name in ("flash_attention_d128_4k", "flash_attention_d112",
                     "flash_attention_d8_f32", "flash_attention_d8"):
            print(cs.json.dumps(cs.kernel_row(
                name, bench.main[name], out["launches"][name])), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
