"""Model API: build a ported architecture from its ModelConfig.

    bundle = build(cfg)
    params = bundle.init(seed, device=None)      # None: the CUDA card
    loss, metrics = bundle.loss(params, batch, opts)
    logits, state = bundle.prefill(params, {"tokens": tokens}, opts, pad_to)
    logits, state = bundle.decode(params, token, state)

``params`` is the port's tree of tensors on one device
(``models/transformer.py``); ``models/weights.py`` makes one from the JAX
package's parameter tree. Only the dense family is ported; the others
raise.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..kernels._compat import resolve_device
from . import transformer as tf
from .layers import ParamSpec, init_param
from .transformer import FwdOpts


def _map_spec(fn, spec):
    if isinstance(spec, ParamSpec):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    return [_map_spec(fn, v) for v in spec]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (None: the CUDA card): matrices in the config's dtype,
    norm parameters in f32. The same seed on the same device gives the
    same weights; the CPU and the card draw different numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = getattr(torch, cfg.dtype)
    return _map_spec(lambda s: init_param(
        s, gen, dtype if s.matrix else torch.float32, dev),
        tf.model_spec(cfg))


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.cfg, seed, device)

    def prefill(self, params: dict, batch: dict, opts: FwdOpts | None = None,
                pad_to: int | None = None):
        return tf.prefill(params, self.cfg, batch["tokens"],
                          opts or FwdOpts(attn_impl="chunked"), pad_to=pad_to)

    def decode(self, params: dict, token: torch.Tensor,
               state: tf.DecodeState):
        return tf.decode_step(params, self.cfg, token, state)

    def loss(self, params: dict, batch: dict, opts: FwdOpts | None = None):
        """(loss, metrics) of a batch of ``tokens`` and ``labels``
        (``transformer.loss_fn``), differentiable in ``params``."""
        return tf.loss_fn(params, self.cfg, batch, opts or FwdOpts())


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet; see "
            f"ROADMAP.md")
    tf.check_dense(cfg)
    return ModelBundle(cfg)
