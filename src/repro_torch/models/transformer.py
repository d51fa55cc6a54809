"""Decoder-only LM assembly for the dense, MoE, hybrid, SSM and VLM
families: prefill, decode and the training forward.

Every layer is a mixer (attention | mamba | rwkv time-mix) and a
feed-forward (mlp | moe | rwkv channel-mix), the JAX package's
``(mixer, ff)`` kinds (``layer_kinds``): dense is attention + MLP in every
layer; jamba interleaves Mamba with one attention layer in eight and MoE
on every other layer; rwkv6 is time-mix + channel-mix throughout.
Parameters are a plain tree of tensors, ``{"embed": {"tok"[, "head"]},
"layers": [per-layer {"norm1", <mixer>, "norm2", <ff>}], "final_norm"}``:
the JAX package's tree, whose ``blocks`` stack each position of the
layer pattern (``pattern``) over its repeats, unstacked into layers
(``models/weights.py`` converts between the two). The layer loop is a
Python loop; the JAX package's ``lax.scan`` over the pattern's groups
has no counterpart the port needs.

Inputs are token ids, or (``cfg.input_mode == "embeddings"``, qwen2-vl's
stubbed vision frontend) precomputed embeddings ``embeds`` with M-RoPE's
(3, B, S) ``positions``.

Four entry points: ``forward_train`` (the final-normed hidden states of
every position and the MoE aux loss, no cache, each layer under
``FwdOpts.remat``: the encoder's forward and the loss's), ``loss_fn``
(causal-LM cross entropy with z-loss and the MoE aux loss), ``prefill``
(build each layer's decode state + last-position logits) and
``decode_step`` (one token for the whole stack).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..sharding.rules import constrain, current_mesh, use_mesh
from . import attention as attn
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .layers import (apply_embed, apply_head, apply_mlp, apply_norm,
                     embed_spec, mlp_spec, norm_spec)


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, ff) per layer, as the JAX package names them."""
    kinds = []
    for l in range(cfg.n_layers):
        if cfg.rwkv:
            kinds.append(("rwkv", "rwkv_ff"))
            continue
        mixer = "attn" if cfg.is_attn_layer(l) else "mamba"
        ff = "moe" if cfg.is_moe_layer(l) else "mlp"
        kinds.append((mixer, ff))
    return kinds


def pattern(cfg) -> tuple[int, int]:
    """(period, n_groups): the smallest repeating prefix of
    ``layer_kinds``, the JAX package's stacking of its parameters (layer
    ``l`` is position ``l % period`` of group ``l // period``)."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and kinds == kinds[:p] * (n // p):
            return p, n // p
    return n, 1


def sublayer_spec(cfg, kind: tuple[str, str]) -> dict:
    mixer, ff = kind
    s: dict = {"norm1": norm_spec(cfg), "norm2": norm_spec(cfg)}
    if mixer == "attn":
        s["attn"] = attn.attn_spec(cfg)
    elif mixer == "mamba":
        s["mamba"] = ssm_mod.ssm_spec(cfg)
    else:
        s["rwkv_t"] = rwkv_mod.rwkv_time_spec(cfg)
    if ff == "mlp":
        s["mlp"] = mlp_spec(cfg)
    elif ff == "moe":
        s["moe"] = moe_mod.moe_spec(cfg)
    else:
        s["rwkv_c"] = rwkv_mod.rwkv_channel_spec(cfg)
    return s


def model_spec(cfg) -> dict:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encoder-decoder family's spec "
                         f"is models/whisper.whisper_spec")
    return {"embed": embed_spec(cfg),
            "layers": [sublayer_spec(cfg, k) for k in layer_kinds(cfg)],
            "final_norm": norm_spec(cfg)}


class DecodeState(NamedTuple):
    caches: list          # per layer: attn.KVCache (B, S_max, K, hd),
                          # ssm.SSMState or rwkv.RWKVState
    pos: int              # absolute position of the next token
    cache_len: int        # number of valid cached positions


def init_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                device=None) -> list:
    """Each layer's empty decode state: a KV ring for attention, an f32
    h and a ``dtype`` conv tail for Mamba, an f32 WKV state and ``dtype``
    shifts for RWKV (the JAX package's ``init_caches``)."""
    caches = []
    for mixer, _ in layer_kinds(cfg):
        if mixer == "attn":
            shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
            caches.append(attn.KVCache(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device)))
        elif mixer == "mamba":
            caches.append(ssm_mod.init_ssm_state(cfg, batch, dtype, device))
        else:
            caches.append(rwkv_mod.init_rwkv_state(cfg, batch, dtype,
                                                   device))
    return caches


@dataclasses.dataclass(frozen=True)
class FwdOpts:
    """The JAX package's forward options that act in the port (its
    ``attn_chunk`` and ``unroll`` have no counterpart: see
    ``RunConfig``)."""
    attn_impl: str = "xla"      # xla | chunked (the flash kernel)
    remat: str = "nothing_saveable"  # nothing_saveable | dots | none


#: the products the ``"dots"`` policy keeps: JAX's
#: ``checkpoint_dots_with_no_batch_dims`` keeps the matrix products'
#: outputs, which the port's layers take as 2-D ``mm`` / ``addmm`` (and
#: ``bmm`` where a product keeps a batch dim)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _under_mesh(fn, mesh):
    def run(*a):
        with use_mesh(mesh):
            return fn(*a)
    return run


def _remat(fn, name: str):
    """``fn`` under the JAX package's remat policy ``name``, per layer, by
    ``torch.utils.checkpoint`` (non-reentrant): ``"nothing_saveable"``
    keeps only the layer's inputs and recomputes the whole layer in the
    backward, ``"dots"`` keeps the matrix products' outputs and
    recomputes the rest, ``"none"`` keeps everything. Without grad there
    is nothing to keep, and ``fn`` runs as it is.

    Under a mesh the recomputation runs under the same mesh: on CUDA
    tensors the autograd engine runs the backward on a thread of its
    own, where the caller's ambient mesh (``sharding.use_mesh``) is not
    set."""
    if name not in ("nothing_saveable", "dots", "none"):
        raise ValueError(f"unknown remat policy {name!r}")
    if name == "none" or not torch.is_grad_enabled():
        return fn
    mesh = current_mesh()
    if mesh is not None:
        fn = _under_mesh(fn, mesh)
    if name == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _layer(p: dict, x: torch.Tensor, cfg, kind: tuple[str, str], *,
           positions, impl: str = "xla", state=None, decode: bool = False,
           train: bool = False):
    """One layer: (x out, aux (0-d f32 MoE aux loss, or None), new decode
    state or None). ``decode``: one token against ``state`` (a KV ring
    written in place at ``state[1]``; see ``decode_step``). ``train``:
    the training forward's attention (``attention_train``: no cache, the
    sequence-parallel layout under a mesh that wants it) and the Mamba
    and RWKV recurrences as the chunked torch ops, which autograd
    differentiates; otherwise (prefill and decode) those recurrences are
    the scan kernels (``kernels.ops.ssm_scan`` and ``wkv``)."""
    mixer, ff = kind
    cache = state[0] if decode else None
    h = apply_norm(p["norm1"], x, cfg.norm)
    if mixer == "attn":
        if decode:
            y, new = attn.attention_decode(
                p["attn"], h, cfg, cache, pos=state[1], cache_len=state[2],
                positions=positions)
        elif train:
            y, new = attn.attention_train(p["attn"], h, cfg,
                                          positions=positions,
                                          impl=impl), None
        else:
            y, new = attn.attention_prefill(p["attn"], h, cfg,
                                            positions=positions, impl=impl)
    elif mixer == "mamba":
        y, new = ssm_mod.mamba_forward(p["mamba"], h, cfg, state=cache,
                                       chunked=not decode, train=train)
    else:
        y, (s_wkv, shift_t) = rwkv_mod.rwkv_time_mix(
            p["rwkv_t"], h, cfg, state=cache, train=train)
    x = x + y
    h = apply_norm(p["norm2"], x, cfg.norm)
    aux = None
    if ff == "mlp":
        y = apply_mlp(p["mlp"], h, cfg)
    elif ff == "moe":
        y, aux = moe_mod.apply_moe_sharded(p["moe"], h, cfg,
                                           no_drop=decode)
    else:
        y, shift_c = rwkv_mod.rwkv_channel_mix(p["rwkv_c"], h, cfg,
                                               state=cache)
        new = rwkv_mod.RWKVState(s=s_wkv, shift_t=shift_t.to(x.dtype),
                                 shift_c=shift_c.to(x.dtype))
    return x + y, aux, new


def _inputs(params: dict, cfg, batch: dict):
    """(x (B, S, d), positions): the embedded tokens, or ``embeds`` in the
    config's dtype for ``input_mode == "embeddings"``; ``positions`` from
    the batch ((3, B, S) for M-RoPE) or 0 .. S-1."""
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
    else:
        x = apply_embed(params["embed"], batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    return x, positions


def forward_train(params: dict, cfg, batch: dict,
                  opts: FwdOpts = FwdOpts()):
    """batch: ``{"tokens": (B, S) int}`` or ``{"embeds": (B, S, d)}``,
    optionally ``"positions"`` ((B, S), or (3, B, S) for M-RoPE).
    Returns the final-normed hidden states (B, S, d) and the MoE aux loss
    summed over the MoE layers, a 0-d f32 tensor (zero without MoE).

    Not under ``torch.inference_mode``, so gradients flow through it
    (through the flash kernel's hand-written backward with
    ``attn_impl="chunked"``); each layer runs under ``opts.remat``.
    Callers that only embed wrap it themselves."""
    x, positions = _inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        def layer(p, x, kind=kind):
            y, a, _ = _layer(p, x, cfg, kind, positions=positions,
                             impl=opts.attn_impl, train=True)
            return y, (a if a is not None else torch.zeros_like(aux))
        x, a = _remat(layer, opts.remat)(p, x)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


def loss_fn(params: dict, cfg, batch: dict, opts: FwdOpts = FwdOpts(),
            z_coef: float = 1e-4, aux_coef: float | None = None):
    """Causal-LM cross entropy with z-loss, the JAX package's arithmetic:
    labels = ``batch["labels"]`` (B, S), entries of -100 (any negative)
    masked; f32 logits; ``loss = ce + z_coef * mean(lse^2) + aux_coef *
    moe_aux`` (``aux_coef`` defaults to ``cfg.router_aux_coef``). Returns
    (loss, {"ce", "z_loss", "moe_aux", "tokens"}), 0-d f32 tensors."""
    x, aux = forward_train(params, cfg, batch, opts)
    # under a mesh, the vocab-sharded logits are gathered whole over
    # "model" first: DTensor has no vocab-parallel gather of the labels'
    # logits (a no-op on plain tensors)
    logits = constrain(apply_head(params["embed"], x).float(),
                       ("batch", None, None))
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    zl = z_coef * ((lse * mask) ** 2).sum() / denom
    ac = cfg.router_aux_coef if aux_coef is None else aux_coef
    loss = ce + zl + ac * aux
    return loss, {"ce": ce, "z_loss": zl, "moe_aux": aux,
                  "tokens": mask.sum()}


@torch.inference_mode()
def prefill(params: dict, cfg, batch: dict,
            opts: FwdOpts = FwdOpts(attn_impl="chunked"),
            pad_to: int | None = None):
    """Full forward over the prompt (``batch`` as for ``forward_train``);
    returns (logits (B, 1, V) f32 at the LAST position, DecodeState).

    pad_to: reserve KV-cache capacity for decode (defaults to the prompt
    length: the decode ring then overwrites the oldest slot). The Mamba
    and RWKV states have no length."""
    x, positions = _inputs(params, cfg, batch)
    b, s = x.shape[:2]
    caches = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        x, _, c = _layer(p, x, cfg, kind, positions=positions,
                         impl=opts.attn_impl)
        if isinstance(c, attn.KVCache) and pad_to is not None and pad_to > s:
            # the JAX package pads the stacked caches after the scan; one
            # layer at a time holds one unpadded cache at a time
            c = attn.KVCache(*(torch.cat([t, t.new_zeros(
                (b, pad_to - s) + t.shape[2:])], dim=1) for t in c))
        caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x[:, -1:, :])
    return logits.float(), DecodeState(caches=caches, pos=s, cache_len=s)


@torch.inference_mode()
def decode_step(params: dict, cfg, token: torch.Tensor, state: DecodeState,
                positions: torch.Tensor | None = None):
    """One token for the whole stack. token: (B, 1) int, or (B, 1, d)
    embeddings for ``input_mode == "embeddings"``; ``positions``: M-RoPE's
    (3, B, 1) ids (else the token is at ``state.pos``). Returns (logits
    (B, 1, V) f32, new DecodeState); the KV rings are updated in place,
    the Mamba and RWKV states replaced."""
    if cfg.input_mode == "embeddings" and token.ndim == 3:
        x = token.to(getattr(torch, cfg.dtype))
    else:
        x = apply_embed(params["embed"], token)
    caches = []
    for p, kind, c in zip(params["layers"], layer_kinds(cfg), state.caches):
        x, _, nc = _layer(p, x, cfg, kind, positions=positions,
                          state=(c, state.pos, state.cache_len), decode=True)
        caches.append(nc)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x)
    s_max = next((c.k.shape[1] for c in caches
                  if isinstance(c, attn.KVCache)), 2**30)
    return logits.float(), DecodeState(
        caches=caches, pos=state.pos + 1,
        cache_len=min(state.cache_len + 1, s_max))
