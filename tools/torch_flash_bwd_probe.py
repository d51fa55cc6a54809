#!/usr/bin/env python3
"""The flash attention backward's kernels alone, on one card.

    python3 tools/torch_flash_bwd_probe.py [--reps N] [--no-edges]

Builds this checkout's flash kernels (``csrc/flash_attention.cu`` for the
forward's lse, ``csrc/flash_attention_bwd.cu``) and prints, as JSON lines:

* ``build``: each backward and wgmma forward kernel's registers and spill
  bytes from the ptxas report, and its HGMMA instructions by variant
  (``cuobjdump``);
* ``edges`` (unless ``--no-edges``): ``chip_smoke.bwd_edge_shapes`` in
  bf16 and f32 through ``flash_bwd_dkdv`` and ``flash_bwd_dq`` on the
  forward kernel's o and lse, each gradient against the plain backward
  (``ref.ref_flash_attention_bwd``) within ``chip_smoke.BWD_TOL``, the
  worst error per gradient and dtype, and the launches by design;
* ``times``: llama3.2-1b's training layer, B 2 x S 4,096, H 32 / K 8,
  D 64, in bf16: dkdv and dq by CUDA events over N calls (default 10) and
  their device time alone (calls queued behind a spin kernel), beside
  SDPA's whole backward and each kernel's bound (four and three products
  over the causal pairs at 989.4 TFLOP/s).

Then the card's name and power limit. Exits non-zero on a failed check.
Needs a CUDA card; about a minute.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
           "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
           "flash_wgmma_kernel", "flash_wgmma_f32_kernel")
PEAK_BF16 = 989.4e12  # dense bf16 tensor-core FLOP/s of an H100 SXM


def build_report() -> dict:
    from repro_torch.kernels import _build
    _build.SOURCES = ("flash_attention", "flash_attention_bwd")
    info = _build.build_all()
    out = {"phase": "build", "seconds": info["seconds"]}
    for src in _build.SOURCES:
        regs = cs.ptxas_by_kernel(info["ptxas"].get(src, ""))
        hg = _build.sass_opcodes_by_function(src, "HGMMA") or {}
        hg = {cs.kernel_label(k): v for k, v in hg.items()}
        out[src] = {k: {**v, "hgmma": hg.get(k, {})}
                    for k, v in sorted(regs.items())
                    if k.split("<")[0] in KERNELS}
    return out


def edges() -> dict:
    from repro_torch.kernels import flash_attention as fa, ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, fails, n = {}, [], 0
    for kern in (fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        kern.by_design.update(dict.fromkeys(kern.by_design, 0))
    for shape in cs.bwd_edge_shapes():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = cs.bwd_inputs(gen, *shape, dt)
            o, lse = fa._forward(q, k, v, lse=True)
            delta = fa.flash_bwd_delta(o, do)
            dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
            want = ref.ref_flash_attention_bwd(
                q, k, v, o, lse, do, bq=cs.PLAIN_FLASH_TILE,
                bk=cs.PLAIN_FLASH_TILE)
            torch.cuda.synchronize()
            for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                ok, err = cs.within(got, w, cs.BWD_TOL[dt])
                key = f"{name}_{str(dt).split('.')[-1]}"
                worst[key] = max(worst.get(key, 0.0), err)
                if not ok or not torch.isfinite(got.float()).all():
                    fails.append([list(shape), str(dt), name, err])
            n += 1
    return {"phase": "edges", "cases": n, "worst_abs_diff": worst,
            "failures": fails[:20], "n_failures": len(fails),
            "by_design": {"dkdv": dict(fa.flash_bwd_dkdv.by_design),
                          "dq": dict(fa.flash_bwd_dq.by_design)}}


def times(reps: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, s, h, kh, d = 2, 4096, 32, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = cs.bwd_inputs(gen, b, s, s, h, kh, d, "contiguous",
                                torch.bfloat16)
    o, lse = fa._forward(q, k, v, lse=True)
    delta = fa.flash_bwd_delta(o, do)
    product = 2 * b * h * d * fa.causal_pairs(s, s)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    def dkdv():
        return fa.flash_bwd_dkdv(q, k, v, do, lse, delta)

    def dq():
        return fa.flash_bwd_dq(q, k, v, do, lse, delta)

    rec = {"phase": "times", "shape": [b, s, h, kh, d], "reps": reps,
           "plan": {k_: v_ for k_, v_ in vars(fa.bwd_plan(q, k, v)).items()
                    if k_ not in ("first_q_tile", "dq_trips", "maps")}}
    for name, fn, n_products in (("dkdv", dkdv, 4), ("dq", dq, 3),
                                 ("sdpa_backward", sdpa, None)):
        rec[name] = {"ms": [cs.cuda_ms(fn, reps) for _ in range(3)],
                     "device_ms": [cs.queued_ms(fn, reps) for _ in range(3)]}
        if n_products:
            rec[name]["bound_ms"] = n_products * product / PEAK_BF16 * 1e3
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-edges", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(build_report()), flush=True)
    bad = False
    if not args.no_edges:
        rec = edges()
        print(json.dumps(rec), flush=True)
        bad = rec["n_failures"] > 0
    print(json.dumps(times(args.reps)), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
