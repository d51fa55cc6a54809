"""Model API: build a ported architecture from its ModelConfig.

    bundle = build(cfg)
    params = bundle.init(seed, device=None)      # None: the CUDA card
    loss, metrics = bundle.loss(params, batch, opts)
    logits, state = bundle.prefill(params, {"tokens": tokens}, opts, pad_to)
    logits, state = bundle.decode(params, token, state)

``params`` is the port's tree of tensors on one device
(``models/transformer.py``, or ``models/whisper.py`` for ``encdec``);
``models/weights.py`` makes one from the JAX package's parameter tree.
Every family is ported: the decoder-only assembly (dense, moe, hybrid,
ssm, vlm) and whisper's encoder-decoder (``encdec``), whose batches carry
the audio frames ``enc_embeds`` beside the ``tokens``.

``batch_specs(cfg, shape)`` gives the shape and dtype of every model
input of an (arch x shape) cell, the JAX package's ``batch_specs`` as
plain dicts: the card path and the tests build their inputs from it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels._compat import resolve_device
from . import transformer as tf
from . import whisper as wh
from .layers import ParamSpec, init_param
from .transformer import FwdOpts


def _map_spec(fn, spec):
    if isinstance(spec, ParamSpec):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    return [_map_spec(fn, v) for v in spec]


def model_spec(cfg: ModelConfig) -> dict:
    """The parameter spec of ``cfg``'s family."""
    return (wh.whisper_spec(cfg) if cfg.family == "encdec"
            else tf.model_spec(cfg))


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
        model_spec(cfg))


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> dict:
        return init_params(self.cfg, seed, device)

    def prefill(self, params: dict, batch: dict, opts: FwdOpts | None = None,
                pad_to: int | None = None):
        """``batch``: ``tokens`` or ``embeds``, and ``positions`` where
        the config needs them (``batch_specs``)."""
        return tf.prefill(params, self.cfg, batch,
                          opts or FwdOpts(attn_impl="chunked"), pad_to=pad_to)

    def decode(self, params: dict, token: torch.Tensor,
               state: tf.DecodeState, positions: torch.Tensor | None = None):
        return tf.decode_step(params, self.cfg, token, state, positions)

    def loss(self, params: dict, batch: dict, opts: FwdOpts | None = None):
        """(loss, metrics) of a batch of ``tokens`` (or ``embeds``) and
        ``labels`` (``transformer.loss_fn``), differentiable in
        ``params``."""
        return tf.loss_fn(params, self.cfg, batch, opts or FwdOpts())


class EncDecBundle(ModelBundle):
    """Whisper's entry points (``models/whisper.py``): batches of
    ``enc_embeds`` (B, S_enc, d) and ``tokens``, and ``labels`` in
    training; decode takes one token against a ``WhisperState``."""

    def prefill(self, params: dict, batch: dict, opts: FwdOpts | None = None,
                pad_to: int | None = None):
        return wh.whisper_prefill(params, self.cfg, batch,
                                  opts or FwdOpts(attn_impl="chunked"),
                                  pad_to=pad_to)

    def decode(self, params: dict, token: torch.Tensor,
               state: wh.WhisperState):
        return wh.whisper_decode_step(params, self.cfg, token, state)

    def loss(self, params: dict, batch: dict, opts: FwdOpts | None = None):
        return wh.whisper_loss_fn(params, self.cfg, batch, opts or FwdOpts())


#: the families ``build`` serves: the decoder-only assembly's, and
#: ``encdec`` (whisper)
FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "encdec")


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); one "
                         f"of {FAMILIES}")
    return EncDecBundle(cfg) if cfg.family == "encdec" else ModelBundle(cfg)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{input name: (shape, dtype)} of every model input of the cell
    (the JAX package's ``batch_specs``): ``tokens`` (B, S) int32 or
    ``embeds`` (B, S, d) bf16, ``labels`` in training, M-RoPE's (3, B, S)
    ``positions``; in decode one new ``token`` (B, 1) (or (B, 1, d)
    embeddings) against an S-long state; whisper (``encdec``) also takes
    ``enc_embeds`` (B, S_enc, d) bf16 in training and prefill."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); one "
                         f"of {FAMILIES}")
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    embeds = cfg.input_mode == "embeddings"
    mrope = cfg.mrope_sections is not None
    if cfg.family == "encdec" and shape.mode != "decode":
        out = {"enc_embeds": ((b, cfg.encoder_seq, cfg.d_model), bf16),
               "tokens": ((b, s), i32)}
        if shape.mode == "train":
            out["labels"] = ((b, s), i32)
        return out
    if shape.mode == "decode":
        out = {"token": ((b, 1, cfg.d_model), bf16) if embeds
               else ((b, 1), i32)}
        if mrope:
            out["positions"] = ((3, b, 1), i32)
        return out
    out = ({"embeds": ((b, s, cfg.d_model), bf16)} if embeds
           else {"tokens": ((b, s), i32)})
    if shape.mode == "train":
        out["labels"] = ((b, s), i32)
    if mrope:
        out["positions"] = ((3, b, s), i32)
    return out


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                          device="meta"):
    """The decode state of a decode cell with no data (``device="meta"``):
    each layer's KV ring of ``shape.seq_len`` positions in bf16, the
    Mamba and RWKV states, whisper's cross K/V over the encoder's
    frames, full (``pos == cache_len == seq_len``). The JAX package's
    ``abstract_decode_state``, per layer."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        kv = (b, s, cfg.n_kv_heads, cfg.hd)
        cross = (b, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)

        def empty(sh):
            return torch.empty(sh, dtype=torch.bfloat16, device=device)
        return wh.WhisperState(
            self_caches=[tf.attn.KVCache(k=empty(kv), v=empty(kv))
                         for _ in range(cfg.n_layers)],
            cross_k=[empty(cross) for _ in range(cfg.n_layers)],
            cross_v=[empty(cross) for _ in range(cfg.n_layers)],
            pos=s, cache_len=s)
    caches = tf.init_caches(cfg, b, s, torch.bfloat16, device=device)
    return tf.DecodeState(caches=caches, pos=s, cache_len=s)
