#!/usr/bin/env python3
"""Can several ranks share one CUDA card over gloo, and run what DTensor
calls on CUDA tensors?

    python3 tools/torch_dist_probe.py [--ranks 4]

Spawns ``--ranks`` processes (a ``FileStore`` in the build tree, no TCP
port), each on card ``rank % device_count``, with the gloo backend, and
tries on CUDA tensors: ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``, the
time of a 64 MiB ``all_reduce``, then on a ("data", "model") mesh a
DTensor matrix product and its backward (against the unsharded
product), a tensor sharded over both mesh dims gathered whole, a
``Partial`` reduced over one mesh dim, and a ``local_map`` with a
``Partial`` output. Then one NCCL rank on a
(1, 1) mesh runs the same DTensor product. Prints one JSON object per
line (each rank's answers and exit code, the NCCL rank's) and, last,
the verdict ``{"gloo_shares_card": bool, ...}``. Each rank appends its
answers to a file as it goes, so a rank that dies in native code still
says what it was doing. Exits 0 when the probe ran, whatever the
answers; 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Answers(dict):
    """A rank's answers, each appended to ``path`` as one JSON line the
    moment it is known: a rank that dies in native code (an abort in a
    backend) leaves the answers it gave and the operation it started."""

    def __init__(self, path: str, **fields):
        super().__init__(fields)
        self.path = path
        self._write({"start": fields})

    def _write(self, obj) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(obj) + "\n")

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._write({key: value})


def _try(out: dict, name: str, fn) -> None:
    """Record ``fn()``'s result under ``name``, or its exception: the
    probe's answer is yes or no per operation."""
    if isinstance(out, Answers):
        out._write({"starting": name})
    try:
        out[name] = {"ok": True, **(fn() or {})}
    except Exception as e:  # noqa: BLE001 - a probe reports every failure
        out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-1500:]}


def _dtensor_matmul(mesh) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dev = mesh.device_type
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, generator=g).to(dev)
    w = torch.randn(32, 16, generator=g).to(dev)
    xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
    wd.requires_grad_()
    (xd @ wd).sum().backward()
    wl = w.clone().requires_grad_()
    (x @ wl).sum().backward()
    err = (wd.grad.full_tensor() - wl.grad).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"grad differs by {err}")
    return {"max_abs_err": err}


def _shard2_full(mesh) -> dict:
    """distribute_tensor over both mesh dims, then full_tensor."""
    from torch.distributed.tensor import Shard, distribute_tensor
    x = torch.arange(64.0, device=mesh.device_type).reshape(8, 8)
    y = distribute_tensor(x, mesh, [Shard(0), Shard(1)]).full_tensor()
    if not torch.equal(y, x):
        raise AssertionError("full_tensor differs")


def _partial_reduce(mesh) -> dict:
    """A Partial over "model" reduced to Replicate (an all_reduce on the
    mesh's sub-group)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    t = torch.ones(8, 8, device=mesh.device_type)
    y = DTensor.from_local(t, mesh, [Replicate(), Partial()]).redistribute(
        mesh, [Replicate(), Replicate()]).to_local()
    if not torch.equal(y, t * mesh.size(1)):
        raise AssertionError("partial sum differs")


def _local_map_partial(mesh) -> dict:
    from torch.distributed.tensor import Partial, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    x = torch.arange(64.0, device=mesh.device_type).reshape(8, 8)
    xd = distribute_tensor(x, mesh, [Shard(0), Shard(1)])
    fn = local_map(lambda t: t * 2, out_placements=[Shard(0), Partial()],
                   in_placements=([Shard(0), Shard(1)],), device_mesh=mesh)
    y = fn(xd).full_tensor()
    half = x.shape[1] // mesh.size(1)
    want = sum((x * 2)[:, i * half:(i + 1) * half]
               for i in range(mesh.size(1)))
    if not torch.equal(y, want):
        raise AssertionError(f"local_map gave {y}, want {want}")
    return {"shape": list(y.shape)}


def _rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    out = Answers(os.path.join(out_dir, f"rank{rank}.jsonl"), rank=rank)
    try:
        dev = rank % torch.cuda.device_count()
        torch.cuda.set_device(dev)
        out["device"] = dev
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        cuda = torch.device("cuda", dev)

        def gather():
            t = torch.full((4,), float(rank), device=cuda)
            o = torch.empty(4 * world, device=cuda)
            dist.all_gather_into_tensor(o, t)
            want = torch.arange(world, device=cuda).repeat_interleave(4)
            assert torch.equal(o, want.float()), o
        _try(out, "all_gather_into_tensor", gather)

        def scatter():
            t = torch.ones(4 * world, device=cuda)
            o = torch.empty(4, device=cuda)
            dist.reduce_scatter_tensor(o, t)
            assert torch.equal(o, torch.full_like(o, world)), o
        _try(out, "reduce_scatter_tensor", scatter)

        def reduce():
            t = torch.full((4,), float(rank), device=cuda)
            dist.all_reduce(t)
            assert torch.equal(t, torch.full_like(t, world * (world - 1)
                                                  / 2)), t
        _try(out, "all_reduce", reduce)

        def to_all():
            t = torch.arange(world, device=cuda).float() + 10 * rank
            o = torch.empty_like(t)
            dist.all_to_all_single(o, t)
            want = torch.arange(world, device=cuda).float() * 10 + rank
            assert torch.equal(o, want), o
        _try(out, "all_to_all_single", to_all)

        def timed():
            t = torch.ones(16 << 20, device=cuda)      # 64 MiB of f32
            dist.all_reduce(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                dist.all_reduce(t)
            torch.cuda.synchronize()
            return {"all_reduce_64MiB_s": (time.perf_counter() - t0) / 3}
        _try(out, "all_reduce_timed", timed)

        from torch.distributed.device_mesh import init_device_mesh
        shape = (2, world // 2) if world % 2 == 0 and world > 1 else (1, 1)
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        _try(out, "dtensor_matmul_bwd", lambda: _dtensor_matmul(mesh))
        _try(out, "shard2_full_tensor", lambda: _shard2_full(mesh))
        _try(out, "partial_reduce", lambda: _partial_reduce(mesh))
        _try(out, "local_map_partial", lambda: _local_map_partial(mesh))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out["fatal"] = f"{type(e).__name__}: {e}"
        out["trace"] = traceback.format_exc()[-2000:]
    out["done"] = True


def _nccl_one(store_path: str, out_dir: str) -> None:
    out = Answers(os.path.join(out_dir, "nccl.jsonl"), rank=0,
                  backend="nccl")
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store_path, 1),
                                rank=0, world_size=1)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        _try(out, "dtensor_matmul_bwd", lambda: _dtensor_matmul(mesh))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out["fatal"] = f"{type(e).__name__}: {e}"
        out["trace"] = traceback.format_exc()[-2000:]
    out["done"] = True


def _spawn(target, args_of, n: int, timeout: float) -> list:
    """Run ``target(*args_of(r))`` in ``n`` spawned processes; their exit
    codes (None: killed at the timeout)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _read(path: str) -> dict:
    """A rank's answers from its JSON lines (``{}`` if it wrote none)."""
    out: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                out.update(json.loads(line))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=240.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dist_probe.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    print(json.dumps({"env": {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "triton": triton_v,
        "devices": torch.cuda.device_count(),
        "nccl_available": dist.is_nccl_available(),
        "gloo_available": dist.is_gloo_available(), "smi": smi}}),
        flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dist_probe_",
                            dir=os.path.join(HERE, "build"))
    try:
        n = args.ranks
        codes = _spawn(_rank, lambda r: (r, n, os.path.join(work, "store"),
                                         work), n, args.timeout)
        ranks = []
        for r in range(n):
            ranks.append(_read(os.path.join(work, f"rank{r}.jsonl")))
            ranks[-1]["exitcode"] = codes[r]
            print(json.dumps(ranks[-1]), flush=True)
        code = _spawn(_nccl_one, lambda r: (os.path.join(work, "store_nccl"),
                                            work), 1, args.timeout)
        nccl = _read(os.path.join(work, "nccl.jsonl"))
        nccl["exitcode"] = code[0]
        print(json.dumps(nccl), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ops = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
           "all_to_all_single", "all_reduce_timed", "dtensor_matmul_bwd",
           "shard2_full_tensor", "partial_reduce", "local_map_partial")
    answers = {op: all(r.get(op, {}).get("ok", False) for r in ranks)
               for op in ops}
    print(smi, flush=True)
    print(json.dumps({
        "gloo_shares_card": all(answers.values()),
        "answers": answers,
        "ranks_per_card": -(-n // torch.cuda.device_count()),
        "nccl_one_rank": nccl.get("dtensor_matmul_bwd", {}).get("ok", False),
        "all_reduce_64MiB_s": [r.get("all_reduce_timed", {}).get(
            "all_reduce_64MiB_s") for r in ranks]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
