#!/usr/bin/env python3
"""The serving flash forward (a null lse pointer), parent against change,
on one card, in turns.

    python3 tools/torch_flash_lse_ab.py PARENT_DIR [--rounds 3]

PARENT_DIR is a checkout of the parent commit (``git archive`` into a
gitignored directory such as ``build/parent``). Each turn is a process of
its own, in the order parent, change, change, parent, that builds its
checkout's kernels and times ``flash_attention`` with no grad (the
serving call, no lse written) at the 32k prefill's layer, B 1 x S 32,768,
H 32 / K 8, D 64, in bf16 (``flash_wgmma_kernel``) and f32
(``flash_wgmma_f32_kernel``): ``--rounds`` rounds of 3 calls each, CUDA
events. The change's turns also time the training call, which writes the
lse. One JSON line per turn, then the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import _build, flash_attention as fa
_build.build_all()
rounds = int(sys.argv[2])
g = torch.Generator(device="cuda").manual_seed(0)
shape = {"q": (1, 32768, 32, 64), "kv": (1, 32768, 8, 64)}
out = {"dir": sys.argv[1]}
for dt in (torch.bfloat16, torch.float32):
    q = torch.randn(*shape["q"], generator=g, device="cuda").to(dt)
    k, v = (torch.randn(*shape["kv"], generator=g, device="cuda").to(dt)
            for _ in range(2))
    calls = {"null_lse": lambda: fa.flash_attention(q, k, v)}
    if hasattr(fa, "_forward"):
        calls["lse"] = lambda: fa._forward(q, k, v, lse=True)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(rounds):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3):
                fn()
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e) / 3)
        out[f"{str(dt).split('.')[-1]}_{name}_ms"] = ms
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    parent = os.path.join(os.path.abspath(args.parent), "src")
    change = os.path.join(HERE, "src")
    for label, src in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", TURN, src,
                              str(args.rounds)], capture_output=True,
                             text=True, check=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": label, **line}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
