"""Training loop: an eager train step + schedules + async delta
checkpoints + straggler monitor + (optional) int8 gradient compression.

The JAX package jits its step and donates the old state; the port's step
is plain Python and torch, with no ``torch.compile``, and the old state is
freed when the new one replaces it. Batches go to the device with
``torch.as_tensor`` and the metrics come back as floats once a step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import torch

from ..configs.base import ModelConfig, RunConfig
from ..ft.checkpoint import CheckpointManager
from ..ft.straggler import StragglerMonitor
from ..kernels._compat import resolve_device
from ..launch.steps import (default_hyper, fwd_opts, make_train_step,
                            value_and_grad)
from ..models import build
from ..models.model import model_spec
from ..sharding.rules import (batch_from_local, distribute_tree, full_tensor,
                              tree_shardings, use_mesh)
from . import grad_compress, schedule
from .optimizer import (apply_updates, clip_by_global_norm, init_state,
                        state_specs)


@dataclasses.dataclass
class TrainerConfig:
    """``warmup_steps`` and ``total_steps`` shape the schedule that
    ``Trainer.lr_at`` reports; the step itself runs at the constant
    ``RunConfig.learning_rate``, as the JAX package's does."""
    total_steps: int = 100
    warmup_steps: int = 10
    ckpt_every: int = 0            # 0 = no checkpoints
    ckpt_dir: str = "ckpts"
    log_every: int = 10
    host: str = "host0"


class Trainer:
    """``device``: where the parameters, the optimizer state and the step
    run (None: the CUDA card); the checkpoint store runs there too.

    ``mesh``: a ``DeviceMesh`` over the ranks of the process group. The
    state is then distributed by the sharding rules (every rank builds the
    same whole state from ``seed`` and keeps its shards), each batch that
    ``run_loop`` takes is this rank's share of the global batch, split
    along the batch dim over the mesh's data axes in rank order, and the
    step runs under the mesh, so DTensor reduces the gradients over the
    ranks. Checkpoints gather each leaf whole and rank 0 writes them."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, tcfg: TrainerConfig,
                 params=None, seed: int = 0, device=None, mesh=None):
        self.cfg, self.run, self.tcfg = cfg, run, tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.bundle = build(cfg)
        self.hyper = default_hyper(cfg, run)
        params = params if params is not None else \
            self.bundle.init(seed, device=self.device)
        opt = init_state(params, self.hyper)
        if mesh is not None:
            spec = model_spec(cfg)
            self.shardings = tree_shardings(spec, mesh)
            params = distribute_tree(params, self.shardings)
            opt = distribute_tree(opt, tree_shardings(
                state_specs(spec, self.hyper), mesh))
        self.state = {"params": params, "opt": opt}
        if run.grad_compress:
            self.state["ef"] = grad_compress.init_error_state(params)
        self.step_fn = self._make_step()
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, async_save=True,
                                       device=self.device)
                     if tcfg.ckpt_every else None)
        self.monitor = StragglerMonitor()
        self.history: list[dict] = []
        self.step = 0

    def _make_step(self):
        base = make_train_step(self.cfg, self.run, self.hyper)
        if not self.run.grad_compress:
            return base
        # compress the grads with error feedback before the optimizer (on
        # a multi-pod mesh the dequantized grads ride the cross-pod
        # reduction; here the pair runs in line and the residual is
        # carried in the state)
        bundle, run, hyper = self.bundle, self.run, self.hyper
        opts = fwd_opts(run)

        def step(state, batch):
            params = state["params"]
            (loss, metrics), grads = value_and_grad(
                lambda p: bundle.loss(p, batch, opts), params)
            grads, ef = grad_compress.compress_grads(grads, state["ef"])
            grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
            new_params, new_opt = apply_updates(hyper, params, grads,
                                                state["opt"])
            m = dict(metrics)
            m.update(loss=loss, grad_norm=gnorm)
            return {"params": new_params, "opt": new_opt, "ef": ef}, m

        return step

    def lr_at(self, step: int) -> float:
        """The warmup-cosine rate at ``step`` (a report: see
        ``TrainerConfig``)."""
        return float(schedule.warmup_cosine(
            step, peak_lr=self.run.learning_rate,
            warmup_steps=self.tcfg.warmup_steps,
            total_steps=self.tcfg.total_steps))

    def run_loop(self, batches: Iterator[dict],
                 hook: Callable[[int, dict], None] | None = None) -> list[dict]:
        for batch in batches:
            if self.step >= self.tcfg.total_steps:
                break
            t0 = time.time()
            jb = {k: torch.as_tensor(v, device=self.device)
                  for k, v in batch.items()}
            if self.mesh is None:
                self.state, metrics = self.step_fn(self.state, jb)
            else:
                jb = batch_from_local(jb, self.mesh)
                with use_mesh(self.mesh):
                    self.state, metrics = self.step_fn(self.state, jb)
            metrics = {k: float(full_tensor(v)) for k, v in metrics.items()}
            dt = time.time() - t0
            self.monitor.record(self.tcfg.host, dt)
            self.step += 1
            metrics.update(step=self.step, step_time=dt)
            self.history.append(metrics)
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(self.step, self.state["params"])
            if hook:
                hook(self.step, metrics)
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    def restore(self, step: int) -> None:
        assert self.ckpt is not None
        if self.mesh is None:
            self.state["params"] = self.ckpt.restore(
                step, like=self.state["params"])
        else:
            self.state["params"] = self.ckpt.restore(
                step, like=self.state["params"], mesh=self.mesh,
                shardings=self.shardings)
        self.step = step
