#!/usr/bin/env python3
"""The flash kernels at the local shapes that ``chip_smoke.py``'s
``distributed`` phase hands them on 4 cards, each timed on one card
against its plain version and SDPA:

* llama3.2-1b on (data 2, model 2): B 1 x S 4,096, H 16 / K 4, D 64;
* qwen2-0.5b on (data 1, model 4), the sequence-parallel branch: rank
  r's 1,024 queries against the first (r + 1) x 1,024 keys, end-aligned,
  H 14 / K 2, D 64 (r = 0 and 3, the least and the most work).

bf16, seeded inputs: the forward (with the log-sum-exp, as training's
forward writes it) and the three backward kernels on its o and lse. SDPA's
mask at Sq < Sk is ``causal_lower_right`` (its ``is_causal`` aligns the
queries to the start of the key axis).

    python3 tools/dist_kernel_shapes.py [--seed 0]

Prints the card's name and power limit, one record per kernel and shape
(``chip_smoke.KernelBench``'s) and, last, ``{"ok": true}``. Exits 0 when
every kernel agreed with its plain version, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, B, Sq, Sk, H, K, D)
SHAPES = (("llama3.2-1b (2, 2)", 1, 4096, 4096, 16, 4, 64),
          ("qwen2-0.5b (1, 4) rank 0", 2, 1024, 1024, 14, 2, 64),
          ("qwen2-0.5b (1, 4) rank 3", 2, 1024, 4096, 14, 2, 64))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dist_kernel_shapes.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import roofline
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    _build.build_all()
    bench = chip_smoke.KernelBench(kops, roofline, smi,
                                   chip_smoke.TIMED_REPS)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for label, b, sq, sk, h, kh, d in SHAPES:
        print(json.dumps({"shape": label}), flush=True)
        q, k, v, do = chip_smoke.bwd_inputs(gen, b, sq, sk, h, kh, d,
                                            "contiguous", torch.bfloat16)
        bench.flash(q, k, v, reps=3, name="flash_attention_train",
                    device=True, lse=True, lower_right=True)
        o, lse = fa._forward(q, k, v, lse=True)
        bench.flash_bwd(q, k, v, o, lse, do)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
