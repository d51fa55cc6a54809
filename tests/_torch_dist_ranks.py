"""One rank of ``tests/test_torch_distributed.py``'s 4-rank gloo run on the
CPU (no JAX here: the test computes the JAX package's answers beforehand
and compares afterwards).

    python tests/_torch_dist_ranks.py WORKDIR RANK WORLD

Reads ``WORKDIR/inputs.pkl`` (written by the test), joins the process
group through a ``FileStore`` in WORKDIR, runs every check, and rank 0
writes ``WORKDIR/outputs.pkl``.
"""
import dataclasses
import logging
import os
import pickle
import sys
import threading

import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig, get_smoke_config
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.elastic import remesh, restore_elastic
from repro_torch.launch.mesh import _mesh, make_test_mesh
from repro_torch.launch.steps import default_hyper, make_train_step
from repro_torch.models import build, weights
from repro_torch.models.model import model_spec
from repro_torch.models.moe import apply_moe_sharded, moe_spec
from repro_torch.sharding import (distribute_tree, shard_batch_specs,
                                  tree_shardings, use_mesh)
from repro_torch.sharding.rules import NamedSharding, distribute
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import init_state, state_specs
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def f32(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def batch_on(mesh, cfg, batch: dict) -> dict:
    specs = {k: (tuple(v.shape), None) for k, v in batch.items()}
    sh = shard_batch_specs(specs, mesh)
    return {k: distribute(torch.as_tensor(v), sh[k]) for k, v in batch.items()}


def train_steps(inp: dict, out: dict, rank: int, root: str):
    """llama3.2-1b-smoke: 2 sharded AdamW steps on (2, 2), then the
    elastic save (from (2, 2)) and restore (onto ranks 0 and 1)."""
    cfg = f32("llama3.2-1b")
    run = RunConfig(attn_impl="chunked", remat="dots")
    hyper = default_hyper(cfg, run)
    mesh = make_test_mesh(device="cpu")
    spec = model_spec(cfg)
    params = weights.from_jax_tree(cfg, inp["llama_params"], device="cpu")
    state = {"params": distribute_tree(params, tree_shardings(spec, mesh)),
             "opt": distribute_tree(init_state(params, hyper), tree_shardings(
                 state_specs(spec, hyper), mesh))}
    batch = batch_on(mesh, cfg, inp["llama_batch"])
    step = make_train_step(cfg, run, hyper)
    plain = {"params": params, "opt": init_state(params, hyper)}
    plain_losses, plain_norms = [], []
    for _ in range(2):
        plain, m = step(plain, {k: torch.as_tensor(v)
                                for k, v in inp["llama_batch"].items()})
        plain_losses.append(float(m["loss"]))
        plain_norms.append(float(m["grad_norm"]))
    losses, norms = [], []
    for _ in range(2):
        with use_mesh(mesh):
            state, m = step(state, batch)
        losses.append(float(full(m["loss"])))
        norms.append(float(full(m["grad_norm"])))
    final = tree_map(full, state["params"])
    layouts = sorted({str(tuple(x.placements))
                      for x in tree_leaves(state["params"])})
    if rank == 0:
        out["llama"] = {"losses": losses, "grad_norms": norms,
                        "plain_losses": plain_losses,
                        "plain_grad_norms": plain_norms,
                        "plain_params": weights.to_jax_tree(
                            cfg, plain["params"]),
                        "params": weights.to_jax_tree(cfg, final),
                        "layouts": layouts, "mesh": tuple(mesh.shape)}

    # elastic: save the sharded params, restore them onto 2 ranks
    ckpt = CheckpointManager(os.path.join(root, "ckpt"), async_save=False,
                             device="cpu")
    ckpt.save(2, state["params"])
    mesh2 = remesh(devices=[0, 1], device="cpu")
    got = restore_elastic(ckpt, 2, like=params, spec_tree=spec, mesh=mesh2)
    if rank < 2:
        same = all(torch.equal(full(g), w) for g, w in
                   zip(tree_leaves(got), tree_leaves(final)))
        placements = sorted({str(tuple(x.placements))
                             for x in tree_leaves(got)})
        if rank == 0:
            out["elastic"] = {"bitwise": same, "mesh": tuple(mesh2.shape),
                              "layouts": placements}


def seq_parallel_loss(inp: dict, out: dict, rank: int):
    """qwen2-0.5b-smoke's loss on (2, 2): 7 heads on a 2-way model axis,
    the sequence-parallel branch."""
    cfg = f32("qwen2-0.5b")
    mesh = make_test_mesh(device="cpu")
    params = weights.from_jax_tree(cfg, inp["qwen_params"], device="cpu")
    dparams = distribute_tree(params, tree_shardings(model_spec(cfg), mesh))
    batch = batch_on(mesh, cfg, inp["qwen_batch"])
    calls = []
    from repro_torch.models import attention
    orig = attention._attention_sharded

    def spy(q, k, v, **kw):
        calls.append((tuple(q.placements), tuple(k.placements)))
        return orig(q, k, v, **kw)
    attention._attention_sharded = spy
    try:
        with use_mesh(mesh), torch.no_grad():
            from repro_torch.models.transformer import FwdOpts
            loss, _ = build(cfg).loss(dparams, batch,
                                      FwdOpts(attn_impl="chunked"))
    finally:
        attention._attention_sharded = orig
    loss = float(full(loss))
    if rank == 0:
        out["qwen"] = {"loss": loss,
                       "placements": [str(c) for c in calls]}


def seq_parallel_grads(inp: dict, out: dict, rank: int):
    """qwen2-0.5b-smoke's gradients on (2, 2) with per-layer remat
    (``dots``), the backward run on a thread of its own, as the autograd
    engine runs it for CUDA tensors (the engine carries the caller's
    thread-local state there, DTensor's implicit replication among it,
    but not its context variables), against the port's unsharded
    gradients."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.transformer import FwdOpts
    cfg = f32("qwen2-0.5b")
    mesh = make_test_mesh(device="cpu")
    bundle = build(cfg)
    opts = FwdOpts(attn_impl="chunked", remat="dots")
    params = weights.from_jax_tree(cfg, inp["qwen_params"], device="cpu")
    _, want = value_and_grad(lambda p: bundle.loss(p, {
        k: torch.as_tensor(v) for k, v in inp["qwen_batch"].items()}, opts),
        params)
    dparams = distribute_tree(params, tree_shardings(model_spec(cfg), mesh))
    live = [p.detach().requires_grad_() for p in tree_leaves(dparams)]
    with use_mesh(mesh):
        loss, _ = bundle.loss(tree_unflatten(dparams, live),
                              batch_on(mesh, cfg, inp["qwen_batch"]), opts)
    got, err = [], []

    def backward():
        try:
            with implicit_replication():
                got.extend(torch.autograd.grad(loss, live))
        except Exception as e:  # reported to the test, which fails on it
            err.append(f"{type(e).__name__}: {str(e)[:2000]}")
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if rank == 0:
        out["qwen_grads"] = {"error": err[0] if err else None}
    if err:
        return
    got = [full(g) for g in got]
    if rank == 0:
        out["qwen_grads"]["pairs"] = [
            (g.numpy(), w.numpy()) for g, w in zip(got, tree_leaves(want))]


def family_losses(inp: dict, out: dict, rank: int):
    """The smoke losses of the other families on (2, 2): the Mamba hybrid,
    RWKV6 (its WKV recurrence per rank) and whisper's encoder-decoder."""
    from repro_torch.models.transformer import FwdOpts
    mesh = make_test_mesh(device="cpu")
    got = {}
    for arch, (jtree, batch) in inp["family"].items():
        cfg = f32(arch)
        params = weights.from_jax_tree(cfg, jtree, device="cpu")
        dparams = distribute_tree(params,
                                  tree_shardings(model_spec(cfg), mesh))
        with use_mesh(mesh), torch.no_grad():
            loss, _ = build(cfg).loss(dparams, batch_on(mesh, cfg, batch),
                                      FwdOpts(attn_impl="chunked"))
        got[arch] = float(full(loss))
    if rank == 0:
        out["family"] = got


def moe(inp: dict, out: dict, rank: int, mode: str):
    """apply_moe_sharded on the test's inputs: EP on (2, 2), TP on
    (1, 4)."""
    cfg = inp[f"moe_{mode}_cfg"]
    shape = (2, 2) if mode == "ep" else (1, 4)
    mesh = _mesh("cpu", shape, ("data", "model"))
    p = {k: torch.as_tensor(v) for k, v in inp[f"moe_{mode}_params"].items()}
    dp = distribute_tree(p, tree_shardings(moe_spec(cfg), mesh))
    x = torch.as_tensor(inp[f"moe_{mode}_x"])
    xd = distribute(x, NamedSharding(mesh, ("data", None, None)))
    with use_mesh(mesh), torch.no_grad():
        y, aux = apply_moe_sharded(dp, xd, cfg)
    y, aux = full(y), full(aux)
    if rank == 0:
        out[f"moe_{mode}"] = {"y": y.numpy(), "aux": float(aux)}


def podwise(inp: dict, out: dict, rank: int):
    """compress_grads then podwise_mean of each pod's gradient on a
    (pod 2, data 2) mesh."""
    mesh = _mesh("cpu", (2, 2), ("pod", "data"))
    g = torch.as_tensor(inp["pod_grads"][mesh.get_local_rank("pod")])
    deq, _ = grad_compress.compress_grads({"w": g},
                                          {"w": torch.zeros_like(g)})
    got = grad_compress.podwise_mean(deq, mesh)["w"]
    gathered = [torch.empty_like(got) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, got)
    if rank == 0:
        out["podwise"] = {"mean": got.numpy(), "same_on_every_rank": all(
            torch.equal(t, got) for t in gathered)}


class StepLog(logging.Handler):
    """The (step, loss, grad norm) of each step the training launcher
    logs, as the floats it logged."""

    def __init__(self):
        super().__init__()
        self.steps: list[tuple] = []

    def emit(self, record):
        if record.msg.startswith("step "):
            self.steps.append(tuple(record.args[:3]))


def launcher(inp: dict, out: dict, rank: int, root: str):
    """``launch/train.main`` with ``REPRO_DISTRIBUTED`` in the group the
    ranks have joined, for each of the test's argument lists: a ("data",)
    mesh over the 4 ranks, each rank its share of each batch; rank 0
    alone writes the checkpoint."""
    from repro_torch.launch import train
    out_l = {}
    for name, argv in inp["launcher_argv"].items():
        log = StepLog()
        logger = logging.getLogger("repro_torch.launch.train")
        logger.addHandler(log)
        os.environ["REPRO_DISTRIBUTED"] = "1"
        try:
            rc = train.main(argv + ["--ckpt-dir", os.path.join(
                root, f"launch_ckpt_{name}")])
        finally:
            del os.environ["REPRO_DISTRIBUTED"]
            logger.removeHandler(log)
        steps = [None] * dist.get_world_size()
        dist.all_gather_object(steps, log.steps)
        out_l[name] = {"rc": rc, "steps": steps, "root": root}
    if rank == 0:
        out["launcher"] = out_l


def main() -> int:
    root, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out: dict = {}
    train_steps(inp, out, rank, root)
    seq_parallel_loss(inp, out, rank)
    seq_parallel_grads(inp, out, rank)
    family_losses(inp, out, rank)
    moe(inp, out, rank, "ep")
    moe(inp, out, rank, "tp")
    podwise(inp, out, rank)
    launcher(inp, out, rank, root)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(root, "outputs.pkl"), "wb") as f:
            pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
