"""Serving launcher: bring up the batched engine + scheduler for an
architecture and run a synthetic request stream.

    python -m repro_torch.launch.serve --arch jamba-v0.1-52b [--smoke]
        [--layers 8] [--requests 16] [--max-new 16] [--max-batch 8]
        [--seed 0] [--device cpu]

``--arch`` takes the token decoders of ``configs.PORTED`` (the dense, MoE,
hybrid and RWKV6 families); qwen2-vl-72b, on embedding inputs, and
whisper-medium, an encoder-decoder on audio frames, raise before a model
is built, since the engine takes token ids alone. ``--layers``
cuts the depth (Jamba-v0.1's 52 B parameters do not fit one card; 8
layers, one period of its 1:7 interleave, are 13.3 B, 26.6 GB in bf16).

The weights are random, from a ``torch.Generator`` seeded with ``--seed``;
the request stream is the JAX package's launcher's (prompts of 4-47
tokens from a numpy generator with the same seed). Without ``--device``
it runs on the CUDA card, and raises if there is none.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np

from ..configs.base import RunConfig, get_config, get_smoke_config
from ..kernels._compat import resolve_device
from ..models import build
from ..obs.log import configure as configure_logging, get_logger
from ..serve.engine import ServeConfig, ServeEngine, check_token_model
from ..serve.scheduler import Scheduler

log = get_logger("launch.serve")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="run only the first N layers (0: all)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the CUDA card)")
    args = ap.parse_args(argv)

    configure_logging("info", stream=sys.stdout)  # CLI progress on stdout
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    check_token_model(cfg)
    device = resolve_device(args.device)
    bundle = build(cfg)
    log.info("initializing %s (%.2fB params) on %s...", cfg.name,
             cfg.param_count() / 1e9, device)
    params = bundle.init(args.seed, device=device)
    engine = ServeEngine(cfg, params,
                         ServeConfig(max_new_tokens=args.max_new,
                                     temperature=args.temperature),
                         run=RunConfig())
    sched = Scheduler(engine, max_batch=args.max_batch)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        n = int(rng.integers(4, 48))
        sched.submit(f"req{i:04d}", rng.integers(3, cfg.vocab, size=n))
    stats = sched.run_until_drained()
    wall = time.time() - t0
    tput = engine.stats["decode_tokens"] / max(wall, 1e-9)
    log.info("%d requests in %.1fs (%.1f tok/s decode); p50 %.2fs p99 %.2fs",
             stats["n_done"], wall, tput, stats["p50_latency_s"],
             stats["p99_latency_s"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
