#!/usr/bin/env python3
"""Time the delta checkpoint of llama3.2-1b at full width, on the card.

    python3 tools/torch_train_ckpt_probe.py [--layers 1] [--seed 0]

The training path's ``CheckpointManager`` saves the parameters as rows of
2,048 f32 lanes of a ``VersionedStore``; at full width even one layer
keeps 323.5M parameters (262.7M of them the tied embedding), 1.3 GB of
rows a save. This trains a copy cut to ``--layers`` layers at the
published width for two steps (B 2 x S 1,024, bf16, RunConfig()
defaults), saves each step synchronously under cProfile, and prints one
JSON line per save (its wall, the store update's, and the persistence
stages: cell extraction, CSR, chain_pack on the card, deflate, file
writes, sha256, fsync, manifest), then restores both steps, from the same
manager and from a fresh one on the directory, and checks them bit for
bit against the saved parameters. The last line is the card's name and
power limit. The store directory is a temporary folder under ``build/``,
removed at the end. ``chip_smoke.py``'s ``train_checkpoint`` phase runs
the same path on a model cut in width too, to fit its time budget.
"""
import argparse
import cProfile
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.train.train_loop import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=args.layers)
    batch = cs.lm_batch(np.random.default_rng(args.seed), cfg.vocab, 2, 1024)
    tr = Trainer(cfg, RunConfig(), TrainerConfig(total_steps=2),
                 seed=args.seed)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_probe_",
                            dir=os.path.join(HERE, "build"))
    try:
        cm = CheckpointManager(root, async_save=False)
        saved = {}
        for step in (1, 2):
            tr.run_loop(iter([batch]))
            params = tr.state["params"]
            saved[step] = [t.clone() for t in tree_leaves(params)]
            walls = {}
            prof = cProfile.Profile()
            with contextlib.ExitStack() as es:
                for obj, name in ((cm, "_persist"), (cm.store, "update")):
                    es.enter_context(cs.timed_calls(obj, name, walls))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prof.enable()
                info = cm.save(step, params)
                prof.disable()
                wall_s = time.perf_counter() - t0
            rows = cm.store.n_rows
            print(json.dumps({
                "phase": "ckpt_save", "step": step, "layers": args.layers,
                "params": cfg.param_count(), "rows": rows,
                "row_bytes": rows * 2048 * 4, "save_s": wall_s,
                "update_s": walls.get("update"),
                "persist_s": walls.get("_persist"),
                "stages_s": cs.save_stages(prof), "changed": info["changed"],
                "disk_bytes": sum(os.path.getsize(os.path.join(p, n))
                                  for p, _, ns in os.walk(root)
                                  for n in ns)}), flush=True)
        like = tr.state["params"]
        out = {"phase": "ckpt_restore", "stats": cm.stats()}
        for name, mgr in (("same", cm), ("reopened", None)):
            if mgr is None:
                t0 = time.perf_counter()
                mgr = CheckpointManager(root)
                out["open_s"] = time.perf_counter() - t0
            for step in (1, 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = mgr.restore(step, like=like)
                torch.cuda.synchronize()
                out[f"{name}_{step}_s"] = time.perf_counter() - t0
                same = all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(got), saved[step]))
                if not same:
                    raise RuntimeError(f"{name} restore of step {step} "
                                       f"differs from the save")
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
