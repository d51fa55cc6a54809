#!/usr/bin/env python3
"""Jamba-v0.1's and rwkv6-7b's serving with the scan kernels and with their
plain versions, in turns, in one process on one card.

    python3 tools/torch_scan_ab.py [--rounds N] [--steps S] [--seed N]

For each of Jamba-v0.1 (8 layers) and rwkv6-7b (32 layers) at their
published widths from seeded weights (``chip_smoke.family_cfg``), the
serving phase's first bucket (``chip_smoke.serving_requests`` and
``first_bucket``) is served by two arms in turns, N rounds (default 10)
in the order kernel, plain, plain, kernel, after one untimed run of each:

* ``kernel``: the served path as it stands, each Mamba or RWKV layer's
  recurrence one launch of ``csrc/ssm_scan.cu`` or ``csrc/wkv.cu``;
* ``plain``: the same path with the model modules' scan wrappers
  replaced by their plain versions on the card (``ref.ssm_scan_chunked``
  in a prefill, ``ref.ssm_scan_sequential`` in a decode step;
  ``ref.wkv_chunked`` in both, as ``rwkv_time_mix`` asks): the torch ops
  the served path ran before the kernels, which is all that differs.

An arm is the bucket's prefill, then S (default 32) greedy decode steps,
each timed alone between two synchronisations; each arm's kernel
launches are checked (one a scan layer a pass, none in ``plain``).
Prints one JSON line per arm run (prefill s, median decode step s), then
one line per model: each arm's median over its runs, and of the 2N pairs
(the two runs of an arm next to each other in a round, each against the
other arm's run beside it) those whose kernel step was faster, with a
two-sided sign test's p, and the decode step's scan call alone
(``decode_call``: the first scan layer's inputs of a decode step, the
wrapper against its plain version, each call's host time with the card
keeping up and its device time queued behind a spin kernel). Then the
card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MODELS = (("jamba-v0.1-52b", 8), ("rwkv6-7b", 32))


@contextlib.contextmanager
def plain_scans():
    """The model modules' scan wrappers replaced by their plain versions
    (on card tensors too) inside the block."""
    from repro_torch.kernels import ref
    from repro_torch.models import rwkv, ssm
    saved = ssm.ssm_scan, rwkv.wkv

    def ssm_plain(*args, chunked=True):
        return (ref.ssm_scan_chunked if chunked
                else ref.ssm_scan_sequential)(*args)

    def wkv_plain(*args, chunked=True):
        return (ref.wkv_chunked if chunked else ref.wkv_sequential)(*args)
    ssm.ssm_scan, rwkv.wkv = ssm_plain, wkv_plain
    try:
        yield
    finally:
        ssm.ssm_scan, rwkv.wkv = saved


@contextlib.contextmanager
def decode_inputs():
    """Keep the first decode-step call's arguments of each scan wrapper
    the model modules make inside the block: {name: (args, kwargs)}."""
    from repro_torch.models import rwkv, ssm
    kept, saved = {}, (ssm.ssm_scan, rwkv.wkv)

    def keep(name, fn):
        def wrapped(*args, **kw):
            if args[0].shape[1] == 1 and name not in kept:
                kept[name] = (args, kw)
            return fn(*args, **kw)
        return wrapped
    ssm.ssm_scan, rwkv.wkv = keep("ssm_scan", saved[0]), keep("wkv",
                                                               saved[1])
    try:
        yield kept
    finally:
        ssm.ssm_scan, rwkv.wkv = saved


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds a call of ``fn`` takes to return, the card
    keeping up (after one warm-up)."""
    fn()
    cs.sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) / reps * 1e6
    cs.sync()
    return out


def call_costs(kops, kept: dict) -> dict:
    """Each kept decode call through its wrapper (the kernel) and its
    plain version, in the order kernel, plain, plain, kernel: host us and
    device ms a call, the mean of each arm's two."""
    from repro_torch.kernels import ref
    plains = {"ssm_scan": (ref.ssm_scan_chunked, ref.ssm_scan_sequential),
              "wkv": (ref.wkv_chunked, ref.wkv_sequential)}
    out = {}
    for name, (args, kw) in kept.items():
        chunked, sequential = plains[name]
        plain = chunked if kw.get("chunked", True) else sequential
        fns = {"kernel": lambda: getattr(kops, name)(*args, **kw),
               "plain": lambda: plain(*args)}
        rec = {"shape": list(args[0].shape), **kw}
        for arm in ("kernel", "plain", "plain", "kernel"):
            for key, val in (("host_us", host_us(fns[arm])),
                             ("device_ms", cs.queued_ms(fns[arm], 50))):
                rec[f"{arm}_{key}"] = rec.get(f"{arm}_{key}", 0) + val / 2
        out[name] = rec
    return out


def synced(fn):
    """(fn's result, its wall in seconds between two synchronisations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve(bundle, params, tokens, steps: int) -> dict:
    """The bucket's prefill, then ``steps`` greedy decode steps."""
    b, s = tokens.shape
    (logits, state), prefill_s = synced(lambda: bundle.prefill(
        params, {"tokens": tokens}, pad_to=s + steps))
    step_s = []
    for _ in range(steps):
        tok = logits[:, 0].argmax(-1, keepdim=True)
        (logits, state), t = synced(
            lambda: bundle.decode(params, tok, state))
        step_s.append(t)
    cs.check(bool(torch.isfinite(logits).all()), "logits not finite")
    return {"prefill_s": prefill_s,
            "decode_step_median_s": statistics.median(step_s)}


def sign_test_p(wins: int, n: int) -> float:
    """Two-sided sign test: the chance of a split at least this uneven
    among ``n`` pairs if each arm were as likely to win."""
    k = min(wins, n - wins)
    return min(1.0, 2 * sum(math.comb(n, i) for i in range(k + 1)) / 2 ** n)


def ab(kops, arch: str, layers: int, rounds: int, steps: int,
       seed: int, smi: str) -> dict:
    from repro_torch.models import build, transformer
    cfg = cs.family_cfg(arch, layers)
    bundle = build(cfg)
    params = bundle.init(seed, device=cs.DEV)
    _, batch = cs.first_bucket(cs.serving_requests(cfg, seed),
                               cs.SERVE_MAX_BATCH)
    tokens = torch.as_tensor(batch, device=cs.DEV)
    kinds = transformer.layer_kinds(cfg)
    per_pass = {"ssm_scan": sum(m == "mamba" for m, _ in kinds),
                "wkv": sum(m == "rwkv" for m, _ in kinds)}

    def run(arm: str) -> dict:
        cs.reset_counts(kops)
        with plain_scans() if arm == "plain" else contextlib.nullcontext():
            rec = serve(bundle, params, tokens, steps)
        got = {k: cs.read_counts(kops)[k] for k in per_pass}
        want = {k: (n * (1 + steps) if arm == "kernel" else 0)
                for k, n in per_pass.items()}
        cs.check(got == want, f"{arch} {arm}: scan launches {got}, not "
                              f"{want}")
        return rec

    with decode_inputs() as kept:
        run("kernel")
    run("plain")
    runs = {"kernel": [], "plain": []}
    pairs = []
    for i in range(rounds):
        recs = {}
        for pos, arm in enumerate(("kernel", "plain", "plain", "kernel")):
            rec = run(arm)
            runs[arm].append(rec)
            recs[pos] = rec["decode_step_median_s"]
            print(json.dumps({"model": arch, "round": i, "arm": arm,
                              **rec}), flush=True)
        pairs += [(recs[0], recs[1]), (recs[3], recs[2])]
    wins = sum(k < p for k, p in pairs)
    out = {"model": arch, "layers": layers, "bucket": list(tokens.shape),
           "steps": steps, "rounds": rounds, "gpu": smi,
           "pairs": len(pairs), "kernel_faster_pairs": wins,
           "sign_test_p": sign_test_p(wins, len(pairs))}
    for arm, recs in runs.items():
        for key in ("prefill_s", "decode_step_median_s"):
            vals = [r[key] for r in recs]
            out[f"{arm}_{key}"] = statistics.median(vals)
            out[f"{arm}_{key}_range"] = [min(vals), max(vals)]
        out[f"{arm}_decode_tokens_per_s"] = (
            tokens.shape[0] / out[f"{arm}_decode_step_median_s"])
    out["decode_call"] = call_costs(kops, kept)
    del params, bundle, kept
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_scan_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops as kops
    _build.build_all()
    smi = cs.nvidia_smi_line()
    for arch, layers in MODELS:
        print(json.dumps(ab(kops, arch, layers, args.rounds, args.steps,
                            args.seed, smi)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
