#!/usr/bin/env python3
"""Where the f32 short-sequence flash kernel's time goes, on one card.

    python3 tools/torch_flash_mma_f32_probe.py [--rounds N]

Builds three copies of this checkout's flash kernels, each into its own
directory under ``build/flash_probe/`` (gitignored):

* ``as_is``: ``flash_mma_f32_kernel`` as it is;
* ``one_product``: each of its three-TF32 products cut to one (hi times
  hi). Its outputs are off in the low bits: it is built for timing only;
* ``no_products``: no product and no softmax at all. The copies in and
  the stores out run through the same pipeline, and every output is 0.

Then times the kernel at the Meta-pipe encoder's shape, B 4,096 x S 32 x
H 8 / K 8, at D 32 and 16 in f32, in each copy, in turns (as_is,
one_product, no_products, no_products, one_product, as_is), N times
(default 1), each in a process of its own: the card's time per call
alone (calls queued behind a spin kernel, ``chip_smoke.queued_ms``), five
measurements of 20 calls. The difference between the copies is what the
products (and their splits) add to the copies. Prints one JSON line per
process, then the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "build", "flash_probe")
ORDER = ("as_is", "one_product", "no_products")

# the f32 kernel's three products of S and of P V, and its per-tile gate
S_PRODUCTS = """\
            mma_tf32(c, ql, kh[2 * n], kh[2 * n + 1]);
            mma_tf32(c, qh, kl[2 * n], kl[2 * n + 1]);
            mma_tf32(c, qh, kh[2 * n], kh[2 * n + 1]);"""
PV_PRODUCTS = """\
          mma_tf32(pv[dn], pl, vh[0], vh[1]);
          mma_tf32(pv[dn], ph, vl[0], vl[1]);
          mma_tf32(pv[dn], ph, vh[0], vh[1]);"""
GATE = """\
    if (j < u.my_trips) {
      const int kt_el"""

CHILD = r"""
import json, sys
variant, src, root = sys.argv[1:4]
sys.path[:0] = [src, root]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build, ops as kops
_build.SOURCES = ("flash_attention",)
_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(3)
rec = {"variant": variant}
for d in (32, 16):
    q, k, v = (torch.randn(4096, 32, 8, d, generator=gen, device="cuda")
               for _ in range(3))
    call = lambda: kops.flash_attention(q, k, v)
    call()
    torch.cuda.synchronize()
    rec[f"D{d}_device_ms"] = [cs.queued_ms(call, cs.TIMED_REPS)
                              for _ in range(5)]
rec["designs"] = {k: n for k, n in kops.flash_attention.by_design.items()
                  if n}
print(json.dumps(rec), flush=True)
"""


def variant_source(text: str, variant: str) -> str:
    """flash_attention.cu as the variant builds it."""
    for pattern in (S_PRODUCTS, PV_PRODUCTS, GATE):
        if pattern not in text:
            raise SystemExit("flash_attention.cu no longer has the f32 "
                             "kernel's products or gate as this probe "
                             "expects them")
    if variant == "one_product":
        return (text.replace(S_PRODUCTS, S_PRODUCTS.splitlines()[2])
                .replace(PV_PRODUCTS, PV_PRODUCTS.splitlines()[2]))
    if variant == "no_products":
        return text.replace(GATE, GATE.replace("u.my_trips)",
                                               "u.my_trips && sk < 0)"))
    return text


def make_copies() -> dict[str, str]:
    """Each variant's copy of src/repro_torch: {variant: its src dir}."""
    shutil.rmtree(PROBE, ignore_errors=True)
    pkg = os.path.join(ROOT, "src", "repro_torch")
    with open(os.path.join(pkg, "csrc", "flash_attention.cu")) as f:
        text = f.read()
    out = {}
    for v in ORDER:
        src = os.path.join(PROBE, v, "src")
        shutil.copytree(pkg, os.path.join(src, "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(src, "repro_torch", "csrc",
                               "flash_attention.cu"), "w") as f:
            f.write(variant_source(text, v))
        out[v] = src
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    srcs = make_copies()
    turn = list(ORDER) + list(reversed(ORDER))
    for _ in range(args.rounds):
        for v in turn:
            subprocess.run([sys.executable, "-c", CHILD, v, srcs[v], ROOT],
                           check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
