#!/usr/bin/env python3
"""``chip_smoke.py``'s ``distributed`` phase alone, on the cards of this
machine:

    python3 tools/dist_phase.py [--seed 0]

Builds the kernels (every source under ``src/repro_torch/csrc``, in
parallel, before any rank starts), then runs
``chip_smoke.phase_distributed``: 4 NCCL ranks, one a card, from 4 cards
up, else one rank on (1, 1) meshes. Prints the card's name and power
limit, the phase's line and, last, ``{"ok": true, ...}``. Exits 0 when
every check of the phase held, 1 when one failed, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dist_phase.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke
    from repro_torch.kernels import _build
    print(chip_smoke.nvidia_smi_line(), flush=True)
    build = _build.build_all()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="dist_phase_",
                            dir=os.path.join(HERE, "build"))
    try:
        chip_smoke.phase_distributed(root, args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, "build_seconds": build["seconds"],
                      "cards": torch.cuda.device_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
