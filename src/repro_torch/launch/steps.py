"""The functions that make the train step, shared by the trainer and its
gradient-compressing variant, and the serve step: one decode step of a
built model. (The JAX package's prefill step builder has no caller in
the port: the serving engine makes its own calls.)

The JAX package jits these; the port's steps are plain Python and torch,
run eagerly. A train step takes and returns ``{"params", "opt"}`` (and the
trainer's ``"ef"``) and leaves the state it was given untouched.

The sharded train step is the same step on a state whose leaves are
DTensors laid out by the sharding rules (``sharding.distribute_tree``),
called under ``sharding.use_mesh(mesh)`` with a batch laid out by
``sharding.shard_batch_specs``: DTensor propagates the layouts through
the model, the flash kernels run per rank on local shards
(``models/attention.py``), and the returned state keeps each leaf's
layout.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import build
from ..models.transformer import FwdOpts
from ..sharding.rules import layout_like
from ..train.optimizer import OptHyper, apply_updates, clip_by_global_norm
from ..train.tree import tree_leaves, tree_map, tree_unflatten


def fwd_opts(run: RunConfig) -> FwdOpts:
    return FwdOpts(attn_impl=run.attn_impl, remat=run.remat)


def default_hyper(cfg: ModelConfig, run: RunConfig) -> OptHyper:
    name = run.optimizer
    if cfg.param_count() > 2e11 and name == "adamw":
        # AdamW's m + v for > 200B parameters outgrow one host's memory
        # budget: the JAX package's rule
        name = "adafactor"
    return OptHyper(name=name, lr=run.learning_rate,
                    weight_decay=run.weight_decay)


def value_and_grad(loss_fn, params):
    """((loss, metrics), grads) of ``loss_fn(params) -> (loss, metrics)``:
    the gradient of every leaf of ``params`` (zeros where the loss does
    not reach one), in the leaf's dtype, as ``jax.value_and_grad(...,
    has_aux=True)`` gives it. A DTensor leaf's gradient is laid out as the
    leaf is: a gradient that autograd leaves as a pending sum over ranks
    (``Partial``) is reduced here, before anything nonlinear reads it."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live))
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else layout_like(g, p)
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _split(name: str, x: torch.Tensor, mb: int) -> list[torch.Tensor]:
    """``mb`` microbatches of a batch entry along its batch dim (dim 1 for
    M-RoPE ``positions`` (3, B, S), else dim 0)."""
    bdim = 1 if name == "positions" else 0
    if x.shape[bdim] % mb:
        raise ValueError(f"{name} {tuple(x.shape)} does not split into "
                         f"{mb} microbatches")
    return list(torch.chunk(x, mb, dim=bdim))


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    hyper: OptHyper | None = None):
    bundle = build(cfg)
    hyper = hyper or default_hyper(cfg, run)
    opts = fwd_opts(run)

    def train_step(state, batch):
        params = state["params"]
        if run.microbatch and run.microbatch > 1:
            # gradient accumulation: grads summed in f32 over the
            # microbatches, then divided by their count
            mb = run.microbatch
            parts = {k: _split(k, v, mb) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(mb):
                mbatch = {k: v[i] for k, v in parts.items()}
                (l_i, _m), g = value_and_grad(
                    lambda p: bundle.loss(p, mbatch, opts), params)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
            zero = torch.zeros_like(loss)
            metrics = {"ce": loss, "z_loss": zero, "moe_aux": zero,
                       "tokens": zero}
        else:
            (loss, metrics), grads = value_and_grad(
                lambda p: bundle.loss(p, batch, opts), params)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        new_params, new_opt = apply_updates(hyper, params, grads,
                                            state["opt"])
        out_metrics = dict(metrics)
        out_metrics.update(loss=loss, grad_norm=gnorm)
        new = {"params": new_params, "opt": new_opt}
        return tree_map(layout_like, new, {k: state[k] for k in new}), \
            out_metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, token, state, positions=None) -> (logits,
    state)``: one decode step, the JAX package's serve step. An
    encoder-decoder (whisper) decodes against its ``WhisperState``, which
    carries the cross K/V, and takes no positions; the decoder-only
    families take M-RoPE's ``positions`` where the config has them."""
    bundle = build(cfg)

    def serve_step(params, token, state, positions=None):
        if cfg.family == "encdec":
            return bundle.decode(params, token, state)
        return bundle.decode(params, token, state, positions)

    return serve_step
