"""Dry run: trace one step of every (arch x shape x mesh) cell on a fake
process group, for its shapes, layouts, FLOPs and collectives.

The JAX package lowers and compiles each cell for a 256- or 512-chip TPU
mesh. The port's counterpart needs no card: rank 0 of a fake process
group of 256 (the (16, 16) mesh) or 512 ranks (the (2, 16, 16) mesh)
builds the state as DTensors laid out by the sharding rules whose local
shards are fake tensors (shapes, no data), and traces one train, prefill
or decode step under a FLOP counter and a collective recorder. This
proves that (a) the sharding rules give every leaf of every cell a
layout the step runs with, (b) the per-device argument bytes fit, and
(c) the per-device FLOPs (``torch.utils.flop_counter``'s formulas on the
local shards; the flash kernels count their causal pairs) and the
collectives DTensor issues (op, bytes, group size) give the roofline
terms (``launch/roofline.py``). The memory term there is the argument
bytes (each input read once), a lower bound: a trace has no compiler's
byte count.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all             # every cell
  python -m repro_torch.launch.dryrun --all --mesh pod  # the 512-rank mesh

Each cell is a process of its own under ``--all`` (a process group's size
is fixed for its life); rows go to ``--out`` (default
``build/dryrun``, which git ignores), one ``<arch>_<shape>_<mesh>.json``
per cell, or ``.FAIL`` with the traceback.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import (ARCH_IDS, SHAPES, RunConfig, get_config,
                            shapes_for)
from ..launch import roofline as rl
from ..launch.mesh import make_production_mesh
from ..launch.steps import default_hyper, make_train_step
from ..models import abstract_decode_state, batch_specs
from ..models.model import model_spec
from ..models.transformer import FwdOpts, pattern
from ..obs.log import configure as configure_logging, get_logger
from ..sharding import (abstract_tree, shard_batch_specs,
                        shard_decode_state, use_mesh)
from ..sharding.rules import contiguous_stride, local_shape, mesh_shape
from ..train.optimizer import state_specs
from ..train.tree import tree_leaves

RESULTS_DIR = os.path.join("build", "dryrun")

log = get_logger("launch.dryrun")


def init_fake_group(world: int) -> None:
    """Rank 0 of a fake process group of ``world`` ranks: collectives
    return at once and move nothing. A group of another size is replaced
    (``--mesh both`` runs both meshes in one process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _split(out) -> int:
    """Over how many ranks a DTensor op's work is split: the product of
    the mesh dims on which its output is sharded (each rank computes a
    block of it) or a partial sum (each rank sums a block of the
    contraction). A dim where the output is replicated has every rank
    do the whole work."""
    from torch.distributed.tensor import DTensor
    t = next((x for x in tree_leaves(out) if isinstance(x, DTensor)), None)
    if t is None:
        return 1
    n = 1
    for dim, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            n *= t.device_mesh.size(dim)
    return n


def local_flop_counter():
    """A dispatch mode that adds up ``torch.utils.flop_counter``'s
    formulas, in ``.flops``: FLOPs per device. An op on plain (local)
    tensors counts as it is. A DTensor op runs whole inside the handler,
    where the mode is off, so neither its sharding propagation (the op
    once more on fake tensors of the global shapes) nor its local op
    reaches the count twice: it counts its global FLOPs over the ranks
    that split its work (:func:`_split`)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(getattr(func, "_overloadpacket",
                                                None))
            if formula is None:
                return out
            flops = formula(*args, **kwargs, out_val=out)
            if any(issubclass(t, DTensor) for t in types):
                flops //= _split(out)
            self.flops += flops
            return out

    return _Counter()


def _local_bytes(tree) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if hasattr(x, "to_local") else x
            total += t.numel() * t.element_size()
    return total


def _abstract_batch(cfg, shape, mesh) -> dict:
    from torch.distributed.tensor import DTensor
    specs = batch_specs(cfg, shape)
    out = {}
    for name, sh in shard_batch_specs(specs, mesh).items():
        gshape, dtype = specs[name]
        local = torch.empty(local_shape(gshape, sh.spec, mesh), dtype=dtype)
        out[name] = DTensor.from_local(local, mesh, sh.placements,
                                       run_check=False,
                                       shape=torch.Size(gshape),
                                       stride=contiguous_stride(gshape))
    return out


def _serving_step(cfg, mode: str):
    """The prefill or decode step that ``cfg``'s model serves, by the
    entry point's undecorated body: the entry points run under
    ``torch.inference_mode``, whose tensors DTensor's fake shards cannot
    be; the dry run traces the same ops under ``no_grad``."""
    from ..models import transformer as tf
    from ..models import whisper as wh
    encdec = cfg.family == "encdec"
    if mode == "prefill":
        body = (wh.whisper_prefill if encdec else tf.prefill).__wrapped__
        return lambda params, batch: body(params, cfg, batch,
                                          FwdOpts(attn_impl="chunked"))
    if encdec:
        body = wh.whisper_decode_step.__wrapped__
        return lambda params, token, state: body(params, cfg, token, state)
    body = tf.decode_step.__wrapped__
    return lambda params, token, state, positions=None: body(
        params, cfg, token, state, positions)


def trace_cell(cfg, shape, mesh, run: RunConfig | None = None) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` under fake
    tensors: {"argument_bytes", "param_bytes", "flops", "collective"}
    per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    run = run or RunConfig()
    dtype = getattr(torch, cfg.dtype)
    with FakeTensorMode(allow_non_fake_inputs=True):
        batch = _abstract_batch(cfg, shape, mesh)
        spec = model_spec(cfg)
        if shape.mode == "train":
            hyper = default_hyper(cfg, run)
            args = ({"params": abstract_tree(spec, mesh, dtype=dtype,
                                             device="cpu"),
                     "opt": abstract_tree(state_specs(spec, hyper), mesh,
                                          device="cpu")}, batch)
            step = make_train_step(cfg, run, hyper)
        elif shape.mode == "prefill":
            args = (abstract_tree(spec, mesh, dtype=dtype,
                                  dtype_override=torch.bfloat16,
                                  device="cpu"), batch)
            step = _serving_step(cfg, "prefill")
        else:
            state = shard_decode_state(
                cfg, abstract_decode_state(cfg, shape, device="cpu"), mesh)
            params = abstract_tree(spec, mesh, dtype=dtype,
                                   dtype_override=torch.bfloat16,
                                   device="cpu")
            args = (params, batch["token"], state)
            if cfg.mrope_sections is not None:
                args = args + (batch["positions"],)
            step = _serving_step(cfg, "decode")
        counter = local_flop_counter()
        recorder = rl.collective_recorder()
        with use_mesh(mesh), recorder, counter, torch.no_grad() \
                if shape.mode != "train" else contextlib.nullcontext():
            step(*args)
    params = args[0]["params"] if shape.mode == "train" else args[0]
    return {"argument_bytes": _local_bytes(args),
            "param_bytes": _local_bytes(params), "flops": counter.flops,
            "collective": rl.collective_bytes(recorder.records)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None) -> dict:
    """One cell's row on the production mesh (256 or 512 fake ranks)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    init_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    return row(cfg, shape, mesh, "2x16x16" if multi_pod else "16x16")


def row(cfg, shape, mesh, mesh_name: str) -> dict:
    """The JAX package's row for a cell traced on ``mesh``."""
    t0 = time.perf_counter()
    cost = trace_cell(cfg, shape, mesh)
    t_trace = time.perf_counter() - t0
    n_dev = 1
    for s in mesh_shape(mesh).values():
        n_dev *= s
    roof = rl.Roofline(flops_per_device=cost["flops"],
                       bytes_per_device=cost["argument_bytes"],
                       collective=cost["collective"],
                       model_flops_global=rl.model_flops(cfg, shape),
                       n_devices=n_dev)
    n_groups = cfg.n_layers if cfg.family == "encdec" else pattern(cfg)[1]
    return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
            "mode": shape.mode, "n_groups": n_groups,
            "t_trace_s": t_trace,
            "memory": {k: cost[k] for k in ("argument_bytes",
                                            "param_bytes")},
            "hlo_ops": {"n_collectives": cost["collective"]["n_ops"]},
            "roofline": roof.as_dict()}


def cell_list(multi_pod: bool, archs=None) -> list[tuple[str, str]]:
    cells = []
    for arch in (archs or ARCH_IDS):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
    return cells


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "pod", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    configure_logging("info", stream=sys.stdout)  # CLI progress on stdout
    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "pod": [True],
              "both": [False, True]}[args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        ok = True
        for mp in meshes:
            tag = f"{args.arch}_{args.shape}_{'pod' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                log.info("[skip] %s", tag)
                continue
            try:
                r = run_cell(args.arch, args.shape, mp)
                with open(path, "w") as f:
                    json.dump(r, f, indent=1)
                log.info("[ok] %s: trace=%.1fs dom=%s frac=%.3f", tag,
                         r["t_trace_s"], r["roofline"]["dominant"],
                         r["roofline"]["roofline_fraction"])
            except Exception:  # a cell's failure is its row: recorded
                ok = False
                with open(os.path.join(args.out, tag + ".FAIL"), "w") as f:
                    f.write(traceback.format_exc())
                log.error("[FAIL] %s", tag)
                traceback.print_exc()
        if dist.is_initialized():
            dist.destroy_process_group()
        return 0 if ok else 1

    # orchestrate: one process per cell
    failures = []
    for mp in meshes:
        for arch, shape in cell_list(mp):
            tag = f"{arch}_{shape}_{'pod' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                log.info("[skip] %s", tag)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--mesh", "pod" if mp else "single", "--out", args.out]
            if args.force:
                cmd.append("--force")
            log.info("[run] %s", tag)
            if subprocess.run(cmd).returncode != 0:
                failures.append(tag)
    log.info("done; %d failures: %s", len(failures), failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
