"""Whisper-style encoder-decoder backbone (whisper-medium, family
``encdec``).

The audio frontend is a stub, as in the JAX package: the encoder takes
precomputed log-mel frame embeddings ``enc_embeds`` (B, S_enc, d); the
conv1d downsampler is out of scope. Sinusoidal positions on both sides
(the JAX package's deviation from learned decoder positions), pre-LN
blocks, a GELU MLP, multi-head attention with q/k/v biases and no RoPE.

Parameters are a plain tree of tensors, ``{"embed": {"tok", "head"},
"enc_layers": [per-layer {"norm1", "attn", "norm2", "mlp"}],
"enc_final", "dec_layers": [per-layer {"norm1", "self_attn", "norm_c",
"cross_attn", "norm2", "mlp"}], "final_norm"}``: the JAX package's tree,
whose ``enc_blocks`` / ``dec_blocks`` stack each leaf over the layers,
unstacked into lists (``models/weights.py`` converts between the two).
The layer loops are Python loops, where the JAX package scans.

Attention: the encoder's self-attention and every cross-attention are
non-causal and run ``xla`` (full f32 logits, torch ops), as in the JAX
package; the decoder's causal self-attention takes ``attn_impl`` (the
flash kernel with ``chunked``, forward and backward). Four entry points:
``encode``, ``whisper_loss_fn`` (cross entropy with z-loss, each layer
under ``FwdOpts.remat``), ``whisper_prefill`` (encode the audio, run the
prompt, keep each layer's self-attention ring and cross K/V) and
``whisper_decode_step`` (one token for the whole decoder).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..sharding.rules import constrain
from . import attention as attn
from .layers import (apply_embed, apply_head, apply_mlp, apply_norm,
                     embed_spec, mlp_spec, norm_spec)
from .transformer import FwdOpts, _remat


def _inv_freq(d: int, device) -> torch.Tensor:
    """The sinusoid's D/2 inverse frequencies with the JAX package's
    ``max(d // 2 - 1, 1)`` divisor, in f32. The power is taken in f64 and
    rounded to f32, as XLA's f32 power rounds it: torch's f32 ``pow`` is
    an ulp off at a few exponents (9 of whisper-medium's 512), and at
    1,500 positions an angle an ulp off moves its sine by 1e-4."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return 1.0 / (10000.0 ** (dim / max(d // 2 - 1, 1)).double()).float()


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) f32 positions 0 .. s-1: sines, then cosines."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def enc_block_spec(cfg) -> dict:
    return {"norm1": norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "norm2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def dec_block_spec(cfg) -> dict:
    return {"norm1": norm_spec(cfg), "self_attn": attn.attn_spec(cfg),
            "norm_c": norm_spec(cfg), "cross_attn": attn.attn_spec(cfg),
            "norm2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def whisper_spec(cfg) -> dict:
    return {"embed": embed_spec(cfg),
            "enc_layers": [enc_block_spec(cfg)
                           for _ in range(cfg.encoder_layers)],
            "enc_final": norm_spec(cfg),
            "dec_layers": [dec_block_spec(cfg) for _ in range(cfg.n_layers)],
            "final_norm": norm_spec(cfg)}


def _enc_layer(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = apply_norm(p["norm1"], x, cfg.norm)
    q, k, v = attn._qkv(p["attn"], h)
    x = x + attn._out(p["attn"], attn.run_attention(q, k, v, causal=False,
                                                    impl="xla"))
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm), cfg)


def encode(params: dict, cfg, frames: torch.Tensor,
           opts: FwdOpts = FwdOpts()) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> (B, S_enc, d) in the
    config's dtype, each layer under ``opts.remat``."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    for p in params["enc_layers"]:
        x = _remat(lambda p, x: _enc_layer(p, x, cfg), opts.remat)(p, x)
    return apply_norm(params["enc_final"], x, cfg.norm)


class WhisperState(NamedTuple):
    self_caches: list     # per decoder layer: attn.KVCache (B, S_max, K, hd)
    cross_k: list         # per decoder layer: (B, S_enc, K, hd), per request
    cross_v: list
    pos: int              # absolute position of the next token
    cache_len: int        # number of valid cached positions


def _dec_sublayers(p: dict, x: torch.Tensor, cfg, positions, *,
                   enc_out=None, cross_kv=None, cache=None, pos=None,
                   cache_len=None, decode: bool = False,
                   impl: str = "xla"):
    """One decoder block: (x out, new self cache, (cross k, cross v)).
    Prefill and training attend causally over the S positions
    (``impl``); ``decode`` runs one token against ``cache`` (written in
    place) and the given ``cross_kv``, whose q alone it computes (the
    JAX package also projects k and v of a zero row, and drops them)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if decode:
        y, new_cache = attn.attention_decode(
            p["self_attn"], h, cfg, cache, pos=pos, cache_len=cache_len,
            use_rope=False)
    else:
        y, new_cache = attn.attention_prefill(
            p["self_attn"], h, cfg, positions=positions, impl=impl,
            use_rope=False)
    x = x + y
    h = apply_norm(p["norm_c"], x, cfg.norm)
    if cross_kv is None:
        q, ck, cv = attn._qkv(p["cross_attn"], h, xkv=enc_out)
    else:
        ck, cv = cross_kv
        q = attn._q(p["cross_attn"], h)
    y = attn.run_attention(q, ck.to(x.dtype), cv.to(x.dtype), causal=False,
                           impl="xla")
    x = x + attn._out(p["cross_attn"], y)
    x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm), cfg)
    return x, new_cache, (ck, cv)


def _dec_inputs(params: dict, cfg, tokens: torch.Tensor):
    """The embedded tokens plus their sinusoid rows, and positions."""
    x = apply_embed(params["embed"], tokens)
    b, s = x.shape[:2]
    x = x + _sinusoid(s, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def whisper_loss_fn(params: dict, cfg, batch: dict,
                    opts: FwdOpts = FwdOpts(), z_coef: float = 1e-4):
    """batch: ``enc_embeds`` (B, S_enc, d), ``tokens`` (B, S), ``labels``
    (B, S), entries of -100 (any negative) masked. The JAX package's
    arithmetic: f32 logits, ``loss = ce + z_coef * mean(lse^2)``. Returns
    (loss, {"ce", "z_loss", "moe_aux" (zero), "tokens"}), 0-d f32
    tensors, differentiable in ``params``; every encoder and decoder
    layer runs under ``opts.remat`` (the JAX package keeps everything:
    the values are the same)."""
    enc_out = encode(params, cfg, batch["enc_embeds"], opts)
    x, positions = _dec_inputs(params, cfg, batch["tokens"])

    def layer(p, x, enc_out):
        return _dec_sublayers(p, x, cfg, positions, enc_out=enc_out,
                              impl=opts.attn_impl)[0]

    for p in params["dec_layers"]:
        x = _remat(layer, opts.remat)(p, x, enc_out)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    # whole over "model" under a mesh, as in transformer.loss_fn
    logits = constrain(apply_head(params["embed"], x).float(),
                       ("batch", None, None))
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((lse - ll) * mask).sum() / denom
    zl = z_coef * ((lse * mask) ** 2).sum() / denom
    return ce + zl, {"ce": ce, "z_loss": zl,
                     "moe_aux": torch.zeros((), dtype=torch.float32,
                                            device=ce.device),
                     "tokens": mask.sum()}


@torch.inference_mode()
def whisper_prefill(params: dict, cfg, batch: dict,
                    opts: FwdOpts = FwdOpts(attn_impl="chunked"),
                    pad_to: int | None = None):
    """Encode ``enc_embeds`` and run the decoder over the prompt
    ``tokens``; returns (logits (B, 1, V) f32 at the last position,
    WhisperState). ``pad_to`` reserves self-attention ring capacity for
    decode (defaults to the prompt length)."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    x, positions = _dec_inputs(params, cfg, batch["tokens"])
    b, s = x.shape[:2]
    caches, cks, cvs = [], [], []
    for p in params["dec_layers"]:
        x, c, (ck, cv) = _dec_sublayers(p, x, cfg, positions,
                                        enc_out=enc_out,
                                        impl=opts.attn_impl)
        if pad_to is not None and pad_to > s:
            c = attn.KVCache(*(torch.cat([t, t.new_zeros(
                (b, pad_to - s) + t.shape[2:])], dim=1) for t in c))
        caches.append(c)
        cks.append(ck)
        cvs.append(cv)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x[:, -1:, :])
    return logits.float(), WhisperState(self_caches=caches, cross_k=cks,
                                        cross_v=cvs, pos=s, cache_len=s)


@torch.inference_mode()
def whisper_decode_step(params: dict, cfg, token: torch.Tensor,
                        state: WhisperState):
    """One token (B, 1) for the whole decoder: (logits (B, 1, V) f32, new
    WhisperState). The sinusoid row is computed at ``state.pos`` (no
    table); the self-attention rings are written in place."""
    x = apply_embed(params["embed"], token)
    ang = float(state.pos) * _inv_freq(cfg.d_model, x.device)
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(x.dtype)
    caches = []
    for p, c, ck, cv in zip(params["dec_layers"], state.self_caches,
                            state.cross_k, state.cross_v):
        x, nc, _ = _dec_sublayers(p, x, cfg, None, cross_kv=(ck, cv),
                                  cache=c, pos=state.pos,
                                  cache_len=state.cache_len, decode=True)
        caches.append(nc)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = apply_head(params["embed"], x)
    s_max = caches[0].k.shape[1]
    return logits.float(), state._replace(
        self_caches=caches, pos=state.pos + 1,
        cache_len=min(state.cache_len + 1, s_max))
