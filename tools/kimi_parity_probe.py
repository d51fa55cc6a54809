#!/usr/bin/env python3
"""kimi-k2's attention gradients at its published widths, on one card:

    python3 tools/kimi_parity_probe.py [--seed 0] [--f64]

Builds the kernels (every source under ``src/repro_torch/csrc``), then
takes ``chip_smoke.py``'s ``families_train`` model (kimi-k2 cut to 1 of
61 layers and 64 of 384 experts, bf16, B 1 x S 4,096, the phase's seeds)
and prints, as JSON lines:

* ``parity``: ``chip_smoke.kimi_parity``: one loss and gradient four ways
  (xla; chunked through the kernels; chunked through the kernels' plain
  versions; the plain forward with the backward kernels), each pair's
  loss, norm and wq / wk / wv distances, and each way's launches;
* ``f64`` (with ``--f64``): on the chunked way's q, k, v (``real``) and
  on seeded unit-scale ones (``seeded``), each with a seeded unit-scale
  dO, in bf16 and in f32 (o and lse from the forward kernel of that
  dtype): the backward kernels' and the plain backward's dQ, dK and dV
  against the same function in f64 (P = exp(S - lse), delta =
  rowsum(dO o), one KV head's group at a time): the largest error in
  units of a bf16 ulp of the f64 value (of 1e-3 of the largest, at
  least) and absolute, the elements over one ulp, and the elements where kernel and plain differ by more than
  ``BWD_TOL`` with the worst of them;
* ``kernel``: the ``flash_bwd_*_d112`` rows of ``chip_smoke.py`` (the
  chunked way's q, k, v, o and lse of its backward, a seeded unit-scale
  dO): each kernel against the plain backward within ``BWD_TOL``, the
  plain values' largest magnitudes, the times.

Then the card's name and power limit and, last, ``{"ok": true}``. No
check of the parity's tolerances is made here (``chip_smoke.py`` makes
them); a kernel row's check fails the probe. Needs a CUDA card; about
two minutes with the build.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def truth_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) in f64 of the backward's function on these inputs:
    causal, Sq == Sk, P = exp(q k^T D^-0.5 - lse), delta = rowsum(dO o),
    one KV head's G query heads at a time."""
    import torch
    b, s, h, d = q.shape
    kh = k.shape[2]
    g, scale = h // kh, d ** -0.5
    f = torch.float64
    dq, dk, dv = (torch.empty(t.shape, dtype=f, device=q.device)
                  for t in (q, k, v))
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    delta = (do.to(f) * o.to(f)).sum(-1)                  # (B, S, H)
    for bi in range(b):
        for j in range(kh):
            hs = slice(j * g, (j + 1) * g)
            qj, doj = (t[bi, :, hs].to(f).transpose(0, 1) for t in (q, do))
            kj, vj = k[bi, :, j].to(f), v[bi, :, j].to(f)
            p = torch.exp(qj @ kj.T * scale
                          - lse[bi, hs].to(f)[..., None]).masked_fill(~mask, 0)
            ds = p * (doj @ vj.T - delta[bi, :, hs].T[..., None])
            dv[bi, :, j] = (p.transpose(-1, -2) @ doj).sum(0)
            dk[bi, :, j] = (ds.transpose(-1, -2) @ qj).sum(0) * scale
            dq[bi, :, hs] = (ds @ kj * scale).transpose(0, 1)
            del p, ds
    return dq, dk, dv


def f64_lines(cs, kops, kept, seed: int) -> None:
    """The ``f64`` lines (see the module docstring)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = (x.detach() for x in kept[:3])
    gen = torch.Generator(device=q.device).manual_seed(seed + 36)
    sets = {"real": (q, k, v),
            "seeded": tuple(torch.randn(x.shape, generator=gen,
                                        device=x.device).to(x.dtype)
                            for x in (q, k, v))}
    do0 = torch.randn(q.shape, generator=gen, device=q.device)
    for name, (q0, k0, v0) in sets.items():
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv, do = (x.to(dt) for x in (q0, k0, v0, do0))
            o, lse = fa._forward(qq, kk, vv, lse=True)
            delta = kops.flash_bwd_delta(o, do)
            dk, dv = kops.flash_bwd_dkdv(qq, kk, vv, do, lse, delta)
            got = (kops.flash_bwd_dq(qq, kk, vv, do, lse, delta), dk, dv)
            want = ref.ref_flash_attention_bwd(
                qq, kk, vv, o, lse, do, bq=cs.PLAIN_FLASH_TILE,
                bk=cs.PLAIN_FLASH_TILE)
            truth = truth_bwd(qq, kk, vv, o, lse, do)
            atol, rtol = cs.BWD_TOL[dt]
            line = {"probe": "f64", "inputs": name, "dtype": str(dt)}
            for gname, g, w, t in zip(("dq", "dk", "dv"), got, want, truth):
                # a bf16 ulp of the value, or of 1e-3 of the largest
                # (rows near a key's own value cancel to about 0)
                ulp = torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(
                    1e-3 * float(t.abs().max())))) - 7)
                one = {"truth_max": float(t.abs().max())}
                for iname, x in (("kernel", g), ("plain", w)):
                    err = (x.double() - t).abs()
                    one[iname] = {"max_abs": float(err.max()),
                                  "max_ulps": float((err / ulp).max()),
                                  "over_1_ulp": int((err > ulp).sum())}
                d = (g.float() - w.float()).abs()
                over = d > atol + rtol * w.float().abs()
                one["kernel_vs_plain_over_tol"] = int(over.sum())
                if over.any():
                    i = int(torch.argmax(torch.where(
                        over, d, torch.zeros_like(d))))
                    one["worst"] = {"index": list(torch.unravel_index(
                        torch.tensor(i), d.shape)), "kernel": float(
                            g.flatten()[i]), "plain": float(w.flatten()[i]),
                        "f64": float(t.flatten()[i])}
                    one["worst"]["index"] = [int(x) for x in
                                             one["worst"]["index"]]
                line[gname] = one
            print(json.dumps(line), flush=True)
            del got, want, truth, o, lse, delta
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f64", action="store_true",
                    help="hold the D 112 backward against f64 too")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kimi_parity_probe.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke as cs
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.launch import roofline
    from repro_torch.models import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _build.build_all()
    cfg = dataclasses.replace(cs.family_cfg(cs.FT_ARCH, cs.FT_LAYERS),
                              n_experts=cs.FT_EXPERTS)
    run = RunConfig(optimizer="adafactor")
    batch = cs.lm_batch(np.random.default_rng(args.seed + 30), cfg.vocab,
                        cs.FT_BATCH, cs.FT_SEQ)
    params = build(cfg).init(args.seed + 30, device=cs.DEV)
    kept: list = []
    with cs.first_backward_inputs(kept):
        parity = cs.kimi_parity(kops, cfg, params, batch, run.remat)
    print(json.dumps({"probe": "parity", **parity}), flush=True)
    del params
    torch.cuda.empty_cache()
    if args.f64:
        f64_lines(cs, kops, kept[0], args.seed)
    bench = cs.KernelBench(kops, roofline, smi, cs.TIMED_REPS)
    cs.phase_kernel_families_train(bench, {"bwd_inputs": kept[0]},
                                   args.seed)
    for name, row in bench.main.items():
        print(json.dumps({"probe": "kernel", "name": name, **row}),
              flush=True)
    print(smi)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
