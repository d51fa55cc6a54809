#!/usr/bin/env python3
"""The flash attention backward's kernels alone, on one card.

    python3 tools/torch_flash_bwd_probe.py [--reps N] [--no-edges]
                                           [--folds 1,4,0] [--no-times]
                                           [--no-split]

Builds this checkout's flash kernels (``csrc/flash_attention.cu`` for the
forward's lse, ``csrc/flash_attention_bwd.cu``) and prints, as JSON lines:

* ``build``: each backward and wgmma forward kernel's registers and spill
  bytes from the ptxas report, and its HGMMA instructions by variant
  (``cuobjdump``);
* ``edges`` (unless ``--no-edges``): ``chip_smoke.bwd_edge_shapes`` (D
  8 to 128) in bf16 and f32 through ``flash_bwd_dkdv`` and
  ``flash_bwd_dq`` on the forward kernel's o and lse, the lse against the
  plain forward's within ``chip_smoke.LSE_TOL`` and each gradient against
  the plain backward (``ref.ref_flash_attention_bwd``) within
  ``chip_smoke.BWD_TOL``, the worst error per gradient, dtype and head
  dim, and the launches by design;
* ``times`` (unless ``--no-times``): llama3.2-1b's training layer, B 2 x
  S 4,096, H 32 / K 8, D 64, in bf16 and f32, olmo-1b's attention, B 2 x
  S 4,096, H 16 / K 16, D 128, in f32, kimi-k2's, B 1 x S 4,096, H 64 /
  K 8, D 112, in bf16, and the Meta-pipe encoder's shape, B 4,096 x S 32,
  H 8 / K 8, at D 32 and 16 in both dtypes (the mma designs): dkdv and dq
  by CUDA events
  over N calls (default 10) and their device time alone (calls queued
  behind a spin kernel), beside SDPA's whole backward (f32: its
  memory-efficient kernel, k and v repeated over the heads) and each
  kernel's bound (four and three products over the causal pairs at the
  dtype's tensor-core peak: bf16 989.4 TFLOP/s, f32 three TF32 products
  at 494.7), and the f32 gradients' worst error against the plain
  backward, in units of ``BWD_TOL[f32]`` (``tol_ratio``, at most 1 to
  pass);
* ``fold`` (one line per value of ``--folds``): a copy of the sources
  under ``build/flash_probe/fold_<n>/`` with the f32 kernels' ``kFold``
  at that value (trips a tensor-core accumulator sums before it is added
  into the f32 running sums; 0: never, the running sums are the
  accumulator), in a process of its own: its f32 kernels' registers, the
  f32 shapes of ``times``, their errors and times;
* ``no_split`` (with ``--no-split``): a copy whose f32 producers skip
  each trip's split pass (the stages keep stale parts: outputs wrong,
  timing only), in a process of its own: the f32 shapes' times, what the
  producer's splitting and transposing adds.

Then the card's name and power limit. Exits non-zero on a failed check.
Needs a CUDA card; about two minutes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
           "flash_bwd_dkdv_wgmma_f32_kernel", "flash_bwd_dq_wgmma_f32_kernel",
           "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel",
           "flash_bwd_delta_kernel", "flash_wgmma_kernel",
           "flash_wgmma_f32_kernel", "flash_mma_kernel",
           "flash_mma_f32_kernel")
PEAK = {torch.bfloat16: 989.4e12, torch.float32: 494.7e12 / 3}
# (name, B, S, H, K, D, dtype): llama3.2-1b's training layer in both
# dtypes, olmo-1b's attention in f32, kimi-k2's in bf16, the Meta-pipe
# encoder's shape at D 32 and 16 in both
SHAPES = (("llama_bf16", 2, 4096, 32, 8, 64, torch.bfloat16),
          ("llama_f32", 2, 4096, 32, 8, 64, torch.float32),
          ("olmo_d128_f32", 2, 4096, 16, 16, 128, torch.float32),
          ("kimi_d112", 1, 4096, 64, 8, 112, torch.bfloat16),
          ("encoder_d32", 4096, 32, 8, 8, 32, torch.bfloat16),
          ("encoder_d32_f32", 4096, 32, 8, 8, 32, torch.float32),
          ("encoder_d16", 4096, 32, 8, 8, 16, torch.bfloat16),
          ("encoder_d16_f32", 4096, 32, 8, 8, 16, torch.float32))


def build_report() -> dict:
    from repro_torch.kernels import _build
    _build.SOURCES = ("flash_attention", "flash_attention_bwd")
    info = _build.build_all()
    out = {"phase": "build", "seconds": info["seconds"],
           "flags": list(_build.NVCC_FLAGS)}
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
            _, lse_want = ref.ref_flash_attention(
                q, k, v, bq=cs.PLAIN_FLASH_TILE, bk=cs.PLAIN_FLASH_TILE,
                return_lse=True)
            seen = lse_want > -1e29
            ok, err = cs.within(lse[seen], lse_want[seen], cs.LSE_TOL)
            key = f"lse_{str(dt).split('.')[-1]}_d{shape[5]}"
            worst[key] = max(worst.get(key, 0.0), err)
            if not ok or not bool((lse[~seen] == -1e30).all()):
                fails.append([list(shape), str(dt), "lse", err])
            delta = fa.flash_bwd_delta(o, do)
            dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
            want = ref.ref_flash_attention_bwd(
                q, k, v, o, lse, do, bq=cs.PLAIN_FLASH_TILE,
                bk=cs.PLAIN_FLASH_TILE)
            torch.cuda.synchronize()
            for name, got, w, tol in zip(
                    ("dq", "dk", "dv", "delta"), (dq, dk, dv, delta),
                    (*want, ref.ref_flash_bwd_delta(o, do)),
                    (cs.BWD_TOL[dt],) * 3 + (cs.BWD_TOL[torch.float32],)):
                ok, err = cs.within(got, w, tol)
                key = f"{name}_{str(dt).split('.')[-1]}_d{shape[5]}"
                worst[key] = max(worst.get(key, 0.0), err)
                if not ok or not torch.isfinite(got.float()).all():
                    fails.append([list(shape), str(dt), name, err])
            if shape[1] > shape[2] and not (dq[:, :shape[1] - shape[2]]
                                            == 0).all():
                fails.append([list(shape), str(dt), "dq_unseen_rows", None])
            n += 1
    return {"phase": "edges", "cases": n, "worst_abs_diff": worst,
            "failures": fails[:20], "n_failures": len(fails),
            "by_design": {"dkdv": dict(fa.flash_bwd_dkdv.by_design),
                          "dq": dict(fa.flash_bwd_dq.by_design)}}


def tol_ratio(got, want, tol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within tol."""
    d = (got.float() - want.float()).abs()
    return float((d / (tol[0] + tol[1] * want.float().abs())).max())


def time_shape(name, b, s, h, kh, d, dt, reps, check=True) -> dict:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa, ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = cs.bwd_inputs(gen, b, s, s, h, kh, d, "contiguous", dt)
    o, lse = fa._forward(q, k, v, lse=True)
    delta = fa.flash_bwd_delta(o, do)
    product = 2 * b * h * d * fa.causal_pairs(s, s)
    bf16 = dt == torch.bfloat16
    kr, vr = (k, v) if bf16 else (x.repeat_interleave(h // kh, 2)
                                  for x in (k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, kr, vr))
    ctx = (contextlib.nullcontext if bf16
           else lambda: sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION))
    with ctx():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=bf16)
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        with ctx():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

    def dkdv():
        return fa.flash_bwd_dkdv(q, k, v, do, lse, delta)

    def dq():
        return fa.flash_bwd_dq(q, k, v, do, lse, delta)

    plan = fa.bwd_plan(q, k, v)
    rec = {"shape": [b, s, h, kh, d, str(dt)], "reps": reps,
           "plan": {k_: v_ for k_, v_ in dataclasses.asdict(plan).items()
                    if k_ not in ("first_q_tile", "dq_trips", "maps")}}
    if not bf16 and check:
        dk_, dv_ = dkdv()
        dq_ = dq()
        want = ref.ref_flash_attention_bwd(q, k, v, o, lse, do,
                                           bq=cs.PLAIN_FLASH_TILE,
                                           bk=cs.PLAIN_FLASH_TILE)
        rec["tol_ratio"] = {n: tol_ratio(g, w, cs.BWD_TOL[dt]) for n, g, w
                            in zip(("dq", "dk", "dv"), (dq_, dk_, dv_), want)}
        rec["max_abs"] = {n: float(w.abs().max()) for n, w
                          in zip(("dq", "dk", "dv"), want)}
        del want, dk_, dv_, dq_
    for kname, fn, n_products in (("dkdv", dkdv, 4), ("dq", dq, 3),
                                  ("sdpa_backward", sdpa, None)):
        rec[kname] = {"ms": [cs.cuda_ms(fn, reps) for _ in range(3)],
                      "device_ms": [cs.queued_ms(fn, reps)
                                    for _ in range(3)]}
        if n_products:
            rec[kname]["bound_ms"] = n_products * product / PEAK[dt] * 1e3
    del out, qt, kt, vt
    torch.cuda.empty_cache()
    return {name: rec}


def times(reps: int, f32_only: bool = False, check: bool = True) -> dict:
    rec = {"phase": "times"}
    for shape in SHAPES:
        if f32_only and shape[-1] != torch.float32:
            continue
        rec.update(time_shape(*shape, reps, check=check))
    return rec


# the f32 kernels' fold interval, which a fold copy sets
FOLD = "constexpr int kFold = 1;"
# the f32 producers' per-trip split passes, which the no_split copy drops
SPLITS = ("""      split_tile<L::kBQ, D>(rq, st, st + L::kQPart, th, 0, th + L::kTPart, 0,
                            t);
      split_tile<L::kBQ, D>(rq + L::kQPart, st + 2 * L::kQPart,
                            st + 3 * L::kQPart, th, L::kBQ, th + L::kTPart,
                            L::kBQ, t);""", """        split_tile<L::kBK, D>(rk, st, st + L::kKPart, tt, 0, tt, L::kBK, t);
        split_same<L::kKPart>(rk + L::kKPart, st + 2 * L::kKPart,
                              st + 3 * L::kKPart, t);""")


def variant_build(name: str, edits) -> None:
    """This checkout's flash sources with each (old, new) of ``edits``
    applied to flash_attention_bwd.cu, built under
    build/flash_probe/<name>/ and used by this process from then on."""
    from repro_torch.kernels import _build
    src = Path(ROOT, "build", "flash_probe", name, "csrc")
    src.mkdir(parents=True, exist_ok=True)
    for f in ("hopper.cuh", "common.cuh", "flash_attention.cu"):
        shutil.copy(_build.CSRC / f, src / f)
    text = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit("flash_attention_bwd.cu no longer has what the "
                             f"{name} copy edits; update FOLD / SPLITS")
        text = text.replace(old, new)
    (src / "flash_attention_bwd.cu").write_text(text)
    _build.CSRC, _build.BUILD_ROOT = src, src.parent / "out"


def no_split_child(reps: int) -> None:
    """In a process of its own: the f32 kernels with no per-trip split
    (timing only), their f32 times."""
    variant_build("no_split", [(split, "") for split in SPLITS])
    build_report()
    rec = times(reps, f32_only=True, check=False)
    rec["phase"] = "no_split"
    print(json.dumps(rec), flush=True)


def fold_child(fold: int, reps: int) -> None:
    """In a process of its own: the f32 kernels with kFold = fold, their
    registers and the f32 times."""
    variant_build(f"fold_{fold}", [(FOLD, f"constexpr int kFold = {fold};")])
    rep = build_report()
    rec = {"phase": "fold", "fold": fold,
           "registers": {k: v for k, v in rep["flash_attention_bwd"].items()
                         if "f32" in k}}
    rec.update(times(reps, f32_only=True))
    rec["phase"] = "fold"
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-edges", action="store_true")
    ap.add_argument("--no-times", action="store_true")
    ap.add_argument("--folds", default="",
                    help="comma-separated kFold values to "
                         "build and time beside the default")
    ap.add_argument("--no-split", action="store_true",
                    help="also time the f32 kernels with no per-trip split")
    ap.add_argument("--fold-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--no-split-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    # f32 products in full f32 (the plain backward is the f32 reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fold_child is not None:
        fold_child(args.fold_child, args.reps)
        return 0
    if args.no_split_child:
        no_split_child(args.reps)
        return 0
    print(json.dumps(build_report()), flush=True)
    bad = False
    if not args.no_edges:
        rec = edges()
        print(json.dumps(rec), flush=True)
        bad = rec["n_failures"] > 0
    if not args.no_times:
        rec = times(args.reps)
        print(json.dumps(rec), flush=True)
        bad |= any(r > 1 for k, v in rec.items() if isinstance(v, dict)
                   for r in v.get("tol_ratio", {}).values())
    for fold in filter(None, args.folds.split(",")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--fold-child", fold, "--reps", str(args.reps)],
                       check=True)
    if args.no_split:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--no-split-child", "--reps", str(args.reps)],
                       check=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
