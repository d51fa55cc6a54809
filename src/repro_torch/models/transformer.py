"""Decoder-only LM assembly for the dense family: prefill and decode.

Every layer is attention + MLP (the JAX package's ``("attn", "mlp")``
kind); the other layer kinds (mamba, rwkv, moe) raise. Parameters are a
plain tree of tensors, ``{"embed": {"tok"[, "head"]}, "layers": [per-layer
{"norm1", "attn", "norm2", "mlp"}], "final_norm"}``: the JAX package's tree
with its stacked layer axis unstacked (``models/weights.py`` converts
between the two). The layer loop is a Python loop; the JAX package's
``lax.scan`` over stacked layers has no counterpart the port needs.

Four entry points: ``forward_train`` (the final-normed hidden states of
every position, no cache, each layer under ``FwdOpts.remat``: the
encoder's forward and the loss's), ``loss_fn`` (causal-LM cross entropy
with z-loss), ``prefill`` (build the KV caches + last-position logits)
and ``decode_step`` (one token for the whole stack).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
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


def check_dense(cfg) -> None:
    """Raise for a config with a layer kind the port does not have yet."""
    other = sorted({k for k in layer_kinds(cfg) if k != ("attn", "mlp")})
    if other or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other or [cfg.input_mode]} are not "
            f"ported yet (only attention + MLP on token inputs); see "
            f"ROADMAP.md")


def layer_spec(cfg) -> dict:
    return {"norm1": norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "norm2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def model_spec(cfg) -> dict:
    check_dense(cfg)
    return {"embed": embed_spec(cfg),
            "layers": [layer_spec(cfg) for _ in range(cfg.n_layers)],
            "final_norm": norm_spec(cfg)}


class DecodeState(NamedTuple):
    caches: list          # per layer: attn.KVCache (B, S_max, K, hd)
    pos: int              # absolute position of the next token
    cache_len: int        # number of valid cached positions


def init_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                device=None) -> list:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    return [attn.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]


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


def _remat(fn, name: str):
    """``fn`` under the JAX package's remat policy ``name``, per layer, by
    ``torch.utils.checkpoint`` (non-reentrant): ``"nothing_saveable"``
    keeps only the layer's inputs and recomputes the whole layer in the
    backward, ``"dots"`` keeps the matrix products' outputs and
    recomputes the rest, ``"none"`` keeps everything. Without grad there
    is nothing to keep, and ``fn`` runs as it is."""
    if name not in ("nothing_saveable", "dots", "none"):
        raise ValueError(f"unknown remat policy {name!r}")
    if name == "none" or not torch.is_grad_enabled():
        return fn
    if name == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _layer(p: dict, x: torch.Tensor, cfg, attn_fn):
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, cache = attn_fn(p["attn"], h)
    x = x + y
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h, cfg), cache


def forward_train(params: dict, cfg, batch: dict,
                  opts: FwdOpts = FwdOpts()):
    """batch: ``{"tokens": (B, S) int}``, optionally ``"positions"`` (B,
    S). Returns the final-normed hidden states (B, S, d) and the MoE aux
    loss, a 0-d f32 zero for the dense family.

    Not under ``torch.inference_mode``, so gradients flow through it
    (through the flash kernel's hand-written backward with
    ``attn_impl="chunked"``); each layer runs under ``opts.remat``.
    Callers that only embed wrap it themselves."""
    check_dense(cfg)
    x = apply_embed(params["embed"], batch["tokens"])
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)

    def layer(p, x):
        return _layer(p, x, cfg, lambda pa, h: (attn.attention_train(
            pa, h, cfg, positions=positions, impl=opts.attn_impl), None))[0]

    layer = _remat(layer, opts.remat)
    for p in params["layers"]:
        x = layer(p, x)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: dict, cfg, batch: dict, opts: FwdOpts = FwdOpts(),
            z_coef: float = 1e-4, aux_coef: float | None = None):
    """Causal-LM cross entropy with z-loss, the JAX package's arithmetic:
    labels = ``batch["labels"]`` (B, S), entries of -100 (any negative)
    masked; f32 logits; ``loss = ce + z_coef * mean(lse^2) + aux_coef *
    moe_aux``. Returns (loss, {"ce", "z_loss", "moe_aux", "tokens"}), 0-d
    f32 tensors."""
    x, aux = forward_train(params, cfg, batch, opts)
    logits = apply_head(params["embed"], x).float()
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
def prefill(params: dict, cfg, tokens: torch.Tensor,
            opts: FwdOpts = FwdOpts(attn_impl="chunked"),
            pad_to: int | None = None):
    """Full forward over the prompt; returns (logits (B, 1, V) f32 at the
    LAST position, DecodeState).

    pad_to: reserve KV-cache capacity for decode (defaults to the prompt
    length: the decode ring then overwrites the oldest slot)."""
    check_dense(cfg)
    x = apply_embed(params["embed"], tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    caches = []
    for p in params["layers"]:
        x, c = _layer(p, x, cfg, lambda pa, h: attn.attention_prefill(
            pa, h, cfg, positions=positions, impl=opts.attn_impl))
        if pad_to is not None and pad_to > s:
            # the JAX package pads the stacked caches after the scan; one
            # layer at a time holds one unpadded cache at a time
            c = attn.KVCache(*(torch.cat([t, t.new_zeros(
                (b, pad_to - s) + t.shape[2:])], dim=1) for t in c))
        caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x[:, -1:, :])
    return logits.float(), DecodeState(caches=caches, pos=s, cache_len=s)


@torch.inference_mode()
def decode_step(params: dict, cfg, token: torch.Tensor,
                state: DecodeState):
    """One token for the whole stack. token: (B, 1) int. Returns (logits
    (B, 1, V) f32, new DecodeState); the caches are updated in place."""
    check_dense(cfg)
    x = apply_embed(params["embed"], token)
    caches = []
    for p, c in zip(params["layers"], state.caches):
        x, nc = _layer(p, x, cfg, lambda pa, h, c=c: attn.attention_decode(
            pa, h, cfg, c, pos=state.pos, cache_len=state.cache_len))
        caches.append(nc)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x)
    s_max = caches[0].k.shape[1] if caches else 2**30
    return logits.float(), DecodeState(
        caches=caches, pos=state.pos + 1,
        cache_len=min(state.cache_len + 1, s_max))
