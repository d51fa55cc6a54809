#!/usr/bin/env python3
"""The scan kernels' slice of ``chip_smoke.py`` alone, on one card.

    python3 tools/torch_scan_probe.py [--families] [--seed N]

Builds this checkout's kernels and runs, printing ``chip_smoke.py``'s JSON
lines:

* ``env``: the build, with the scan kernels' registers and spills
  (``scan_registers_by_kernel``);
* ``kernel_edges_scans``: Mamba's selective scan (``csrc/ssm_scan.cu``)
  and RWKV6's WKV recurrence (``csrc/wkv.cu``) at their edge cases
  against their plain versions;
* without ``--families``: both kernels at the families' shapes on seeded
  inputs (Jamba-v0.1's Mamba layer: B 1 x L 4,096, d_inner 8,192, N 16,
  x bf16; rwkv6-7b's layer: B 1 x L 4,096, H 64, Dk 64), each held
  against an f64 run of the sequential plain version beside the plain
  chunked version, and timed (``kernel`` lines);
* with ``--families``: the ``families`` phase (Jamba-v0.1 served at its
  published widths, the other configs a bucket each, the smoke configs
  in f32 on the CPU and the card) and the scan rows on the inputs its
  long prefills handed the kernels, as the kernels line has them.

Then the card's name and power limit. Exits non-zero on a failed check.
Needs a CUDA card; the quick loop for a change to the scan kernels.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def seeded_inputs(seed: int) -> dict:
    """Scan inputs at the families' shapes from a card generator: the
    selective scan's as ``ssm_edge_inputs`` draws them (B and C
    contiguous, x bf16), the WKV recurrence's with the model's decays,
    from zero states as a prefill starts."""
    gen = torch.Generator(device=cs.DEV).manual_seed(seed + 60)
    dt, bm, cm, x, a, _ = cs.ssm_edge_inputs(gen, 1, cs.FAMILY_LONG, 16,
                                             torch.bfloat16)
    dt, x = (t.repeat(1, 1, 8192 // cs.SSM_EDGE_DI + 1)[..., :8192]
             for t in (dt, x))
    a = a.repeat(8192 // cs.SSM_EDGE_DI + 1, 1)[:8192].contiguous()
    h0 = torch.zeros(1, 8192, 16, device=cs.DEV)
    r, k, v, lw, u, _ = cs.wkv_edge_inputs(gen, 1, cs.FAMILY_LONG, 64)
    heads = 64 // cs.WKV_EDGE_HEADS[64] + 1
    r, k, v, lw = (t.repeat(1, 1, heads, 1)[:, :, :64].contiguous()
                   for t in (r, k, v, lw))
    u = u.repeat(heads, 1)[:64].contiguous()
    s0 = torch.zeros(1, 64, 64, 64, device=cs.DEV)
    return {"ssm_scan_inputs": (dt.contiguous(), bm, cm, x.contiguous(), a,
                                h0),
            "wkv_inputs": (r, k, v, lw, u, s0),
            "launches": {"ssm_scan": 0, "wkv": 0}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_probe.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.launch import roofline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.phase_env(_build.build_all(), smi)
    bench = cs.KernelBench(kops, roofline, smi, cs.TIMED_REPS)
    cs.phase_kernel_edges_scans(bench, args.seed)
    out = (cs.phase_families(kops, args.seed) if args.families
           else seeded_inputs(args.seed))
    cs.phase_kernel_scans(bench, out)
    for name in ("ssm_scan", "wkv"):
        print(cs.json.dumps(cs.kernel_row(name, bench.main[name],
                                          out["launches"][name])),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
