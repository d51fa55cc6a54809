"""GQA attention: parameter shapes, and the prefill and decode paths.

Two softmax-attention implementations, selected by ``RunConfig.attn_impl``:

* ``xla``: full (Sq, Sk) logits in f32 (torch ops here; XLA in the JAX
  package) -- short sequences and the decode's masked ring.
* ``chunked``: the flash algorithm, which never holds the (Sq, Sk) logits.
  The JAX package runs it as an XLA scan over key chunks of
  ``RunConfig.attn_chunk``; the port runs the hand-written CUDA kernel
  ``kernels/flash_attention`` (its plain torch version for CPU tensors).
  The kernel picks its own tiles, so ``attn_chunk`` does not apply to it.
  The JAX scan keeps its (Sq, chunk) logits and probabilities in bf16 in
  the serving prefill (``compact_logits``); the kernel keeps them in f32,
  as the JAX package's Pallas kernel does. In training
  (``transformer.forward_train``) the JAX package differentiates the
  scan; the port runs the kernel's hand-written backward
  (``FlashAttentionFn``). The JAX package's sequence-parallel split of the
  queries (``_wants_seq_parallel``) needs a mesh; one card has none
  (ROADMAP.md Queue 1 item 3).

Whisper's encoder self-attention and its cross-attention (k and v from
the encoder's output, ``_qkv``'s ``xkv``) are non-causal and run ``xla``,
as in the JAX package; a non-causal flash design for them is open work
(ROADMAP.md Queue 2).

Decode writes the new K/V into a ring slot (pos % S_max) of the cache, in
place (the JAX package returns a new cache; the port updates the tensors
it was given, which saves a copy of every layer's cache per token), and
attends over the whole ring with a validity mask, in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention import flash_attention
from .layers import ParamSpec, apply_rope

NEG = -1e30


def attn_spec(cfg) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {  # fan-in: the contracted dims (see layers.py)
        "wq": ParamSpec((d, h, hd), fan_in=d),
        "wk": ParamSpec((d, k, hd), fan_in=d),
        "wv": ParamSpec((d, k, hd), fan_in=d),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), "zeros")
        s["bk"] = ParamSpec((k, hd), "zeros")
        s["bv"] = ParamSpec((k, hd), "zeros")
    return s


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, K, hd)
    v: torch.Tensor


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def _q(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p["wq"])
    return q + p["bq"] if "bq" in p else q


def _qkv(p: dict, x: torch.Tensor, xkv: torch.Tensor | None = None):
    """q from ``x``; k and v from ``xkv`` (a cross-attention's source,
    the encoder's output), else from ``x``."""
    xkv = x if xkv is None else xkv
    k, v = _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return _q(p, x), k, v


def _out(p: dict, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd") as one matrix product."""
    h, e, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].reshape(h * e, d)


def _xla_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Full-logits attention in f32. q: (B, Sq, H, D), k/v: (B, Sk, K, D);
    masked logits at -1e30."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, d) * (d ** -0.5)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= kpos[None, :]
    if kv_valid is not None:
        vmask = kv_valid[None, :] if kv_valid.ndim == 1 else kv_valid
        mask = vmask if mask is None else (mask & vmask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def run_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                  impl: str = "xla", kv_valid: torch.Tensor | None = None
                  ) -> torch.Tensor:
    if impl == "chunked" and kv_valid is None:
        if not causal or q_offset != k.shape[1] - q.shape[1]:
            raise NotImplementedError(
                "the flash kernel is causal with the queries at the end of "
                "the key axis")
        return flash_attention(q, k, v)
    return _xla_attention(q, k, v, causal=causal, q_offset=q_offset,
                          kv_valid=kv_valid)


def attention_prefill(p: dict, x: torch.Tensor, cfg, *,
                      positions: torch.Tensor, impl: str = "chunked",
                      use_rope: bool = True):
    """Returns (out, KVCache over the S prefill positions). Training's
    forward runs it too. ``use_rope=False``: no rotary positions
    (whisper's decoder adds sinusoids to its inputs instead)."""
    q, k, v = _qkv(p, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    out = run_attention(q, k, v, causal=True, impl=impl)
    return _out(p, out), KVCache(k=k, v=v)


def attention_decode(p: dict, x: torch.Tensor, cfg, cache: KVCache, *,
                     pos: int, cache_len: int,
                     positions: torch.Tensor | None = None,
                     use_rope: bool = True
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); cache: (B, S_max, K, hd) ring,
    written in place at slot pos % S_max.

    pos: position of the new token; cache_len: count of valid cached
    positions (== S_max when full); positions: the token's rotary
    position ids ((3, B, 1) for M-RoPE), else ``pos``; ``use_rope=False``:
    no rotary positions."""
    b = x.shape[0]
    s_max = cache.k.shape[1]
    q, k, v = _qkv(p, x)
    if use_rope:
        rp = (positions if positions is not None else
              torch.full((b, 1), pos, dtype=torch.int32, device=x.device))
        q = apply_rope(q, rp, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, rp, cfg.rope_theta, cfg.mrope_sections)
    slot = pos % s_max
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    n_valid = min(cache_len + 1, s_max)
    kv_valid = torch.arange(s_max, device=x.device) < n_valid
    out = run_attention(q, cache.k.to(x.dtype), cache.v.to(x.dtype),
                        causal=False, kv_valid=kv_valid)
    return _out(p, out), cache
