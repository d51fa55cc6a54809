"""Training launcher.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 100 \\
        --batch 8 --seq 64 [--smoke] [--device cpu]

Random weights from a ``torch.Generator`` seeded with ``--seed``, and the
JAX package's launcher's synthetic token stream (a numpy generator with
the same seed) through ``TokenPipeline``. The attention is ``xla`` up to
2,048 tokens and ``chunked`` (the flash kernels, forward and backward)
above, the JAX launcher's rule. Without ``--device`` it runs on the CUDA
card, and raises if there is none.

Several processes (the JAX launcher's ``jax.distributed``): with
``REPRO_DISTRIBUTED`` set, under ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``),

    REPRO_DISTRIBUTED=1 torchrun --nproc-per-node 4 \
        -m repro_torch.launch.train --arch llama3.2-1b --smoke

each process joins the process group (NCCL on the card ``LOCAL_RANK``,
gloo with ``--device cpu``; a group the caller has already joined is
used as it is) and reads its own share of each global batch (``host_id
= rank``, ``n_hosts = world size``), as the JAX launcher's hosts do.
The trainer runs on a ("data",) mesh over the ranks
(``launch/mesh.make_data_mesh``): its state is distributed by the
sharding rules, the gradients are reduced over every rank's share, and
rank 0 alone writes the checkpoints.
"""
import argparse
import os
import sys

import numpy as np
import torch.distributed as dist

from ..configs.base import RunConfig, get_config, get_smoke_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..kernels._compat import resolve_device
from ..obs.log import configure as configure_logging, get_logger
from ..train.train_loop import Trainer, TrainerConfig
from .mesh import make_data_mesh

logger = get_logger("launch.train")


def _init_distributed(device) -> tuple:
    """Join the process group torchrun describes in the environment:
    NCCL with each process on the card ``LOCAL_RANK`` (for a CUDA
    ``device``), gloo on the CPU; a group already joined is kept.
    Returns (device, whether this call joined it)."""
    import torch
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device, True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the CUDA card)")
    args = ap.parse_args(argv)
    configure_logging("info", stream=sys.stdout)  # CLI progress on stdout

    device = resolve_device(args.device)
    rank, world, mesh, joined = 0, 1, None, False
    if os.environ.get("REPRO_DISTRIBUTED"):
        device, joined = _init_distributed(device)
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = make_data_mesh(device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = RunConfig(optimizer=args.optimizer, learning_rate=args.lr,
                    microbatch=args.microbatch,
                    grad_compress=args.grad_compress,
                    attn_impl="xla" if args.seq <= 2048 else "chunked")
    tcfg = TrainerConfig(total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 1),
                         ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                         host=f"host{rank}")

    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(3, cfg.vocab, size=args.batch * (args.seq + 1) * 64,
                          dtype=np.int64).astype(np.int32)
    pipe = TokenPipeline(tokens, DataConfig(
        seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        host_id=rank, n_hosts=world))

    logger.info("initializing %s (%.2fB params) on %s...", cfg.name,
                cfg.param_count() / 1e9, device)
    trainer = Trainer(cfg, run, tcfg, seed=args.seed, device=device,
                      mesh=mesh)

    def log(step, m):
        if step % max(args.steps // 10, 1) == 0 or step == 1:
            logger.info("step %5d loss %.4f gnorm %.3f %.2fs", step,
                        m["loss"], m["grad_norm"], m["step_time"])
        verdicts = trainer.monitor.evaluate()
        slow = [h for h, v in verdicts.items() if v != "ok"]
        if slow:
            logger.warning("[straggler] %s", slow)

    hist = trainer.run_loop(iter(pipe), hook=log)
    logger.info("done: %d steps, final loss %.4f", len(hist),
                hist[-1]["loss"])
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
