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
  (``FlashAttentionFn``).

Under a mesh (``sharding.use_mesh``) the parameters and activations are
DTensors. The flash kernel, which launches on raw pointers, and the
full-logits version run per rank on local shards through ``local_map``
(:func:`_attention_sharded`): the batch over the data axes and the heads
over ``model``, or, where the head count does not divide ``model``
(qwen2-0.5b's 14 heads), the training forward's queries over ``model``
with K and V whole (:func:`attention_train`, the JAX package's
sequence-parallel branch).

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
from ..sharding.rules import (constrain, current_mesh, is_dtensor, mesh_shape,
                              pspec_for)
from .layers import ParamSpec, apply_rope

NEG = -1e30


def attn_spec(cfg) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {  # fan-in: the contracted dims (see layers.py)
        "wq": ParamSpec((d, h, hd), fan_in=d,
                        axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, k, hd), fan_in=d,
                        axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, k, hd), fan_in=d,
                        axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), fan_in=h * hd,
                        axes=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h, hd), "zeros", axes=("heads", "head_dim"))
        s["bk"] = ParamSpec((k, hd), "zeros", axes=("kv_heads", "head_dim"))
        s["bv"] = ParamSpec((k, hd), "zeros", axes=("kv_heads", "head_dim"))
    return s


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, K, hd)
    v: torch.Tensor


def _proj(x: torch.Tensor, w: torch.Tensor,
          rows_local: bool = False) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product. A DTensor ``x``
    under ``rows_local`` (the sequence-parallel layout), or whose mesh's
    ``model`` axis does not divide the weight's heads (grok's 8 KV heads
    on a 16-way axis), is projected per rank on its own rows against the
    whole weight (:func:`_proj_rows`): DTensor may otherwise lay the
    product, or the weight's gradient, out over its H e columns, which
    do not split back into heads."""
    d, h, e = w.shape
    if is_dtensor(x) and (rows_local or h % mesh_shape(
            x.device_mesh).get("model", 1)):
        return _proj_rows(x, w)
    # a view, not unflatten: DTensor maps a view's sizes onto the local
    # shard, and runs unflatten on it with the global sizes under
    # inference mode
    y = x @ w.reshape(d, h * e)
    return y.view(*y.shape[:-1], h, e)


def _proj_rows(x, w):
    """:func:`_proj` by ``local_map`` on each rank's rows of ``x``, laid
    out as they are, against the whole weight. The weight's gradient is
    a partial sum over each mesh dim that splits the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    # the rows as they lie; the contracted dim whole
    x_pl = [pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1
            else Replicate() for pl in x.placements]
    w_grad = [Partial() if isinstance(pl, Shard) else Replicate()
              for pl in x_pl]
    fn = local_map(_proj, out_placements=x_pl,
                   in_placements=(x_pl, [Replicate()] * len(x_pl)),
                   in_grad_placements=(x_pl, w_grad),
                   device_mesh=x.device_mesh, redistribute_inputs=True)
    return fn(x, w)


def _q(p: dict, x: torch.Tensor, rows_local: bool = False) -> torch.Tensor:
    q = _proj(x, p["wq"], rows_local)
    return q + p["bq"] if "bq" in p else q


def _qkv(p: dict, x: torch.Tensor, xkv: torch.Tensor | None = None,
         rows_local: bool = False):
    """q from ``x``; k and v from ``xkv`` (a cross-attention's source,
    the encoder's output), else from ``x``. ``rows_local``: as for
    :func:`_proj`."""
    xkv = x if xkv is None else xkv
    k = _proj(xkv, p["wk"], rows_local)
    v = _proj(xkv, p["wv"], rows_local)
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return _q(p, x, rows_local), k, v


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
                  impl: str = "xla", kv_valid: torch.Tensor | None = None,
                  seq_parallel: bool = False) -> torch.Tensor:
    """``seq_parallel``: on DTensors, the queries split over ``model``
    along the sequence (:func:`attention_train`'s branch)."""
    flash = impl == "chunked" and kv_valid is None
    if flash and (not causal or q_offset != k.shape[1] - q.shape[1]):
        raise NotImplementedError(
            "the flash kernel is causal with the queries at the end of "
            "the key axis")
    if is_dtensor(q):
        return _attention_sharded(q, k, v, flash=flash, causal=causal,
                                  q_offset=q_offset, kv_valid=kv_valid,
                                  seq_parallel=seq_parallel)
    if flash:
        return flash_attention(q, k, v)
    return _xla_attention(q, k, v, causal=causal, q_offset=q_offset,
                          kv_valid=kv_valid)


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _attention_sharded(q, k, v, *, flash: bool, causal: bool,
                       q_offset: int, kv_valid, seq_parallel: bool):
    """Attention on DTensors q (B, Sq, H, D) and k, v (B, Sk, K, D), run
    per rank on local shards by ``local_map``: the flash kernel
    (``flash``; causal, end-aligned), which launches on raw pointers and
    never sees a DTensor, or the full-logits version. The batch shards
    over the data axes (as the rules lay out ``"batch"``), and over
    ``model``:

    * the heads, where ``model`` divides H. K and V shard with them where
      it divides K too; else they stay whole on every model peer, and
      each rank takes the KV heads of its query heads: a contiguous slice
      where its heads cover whole groups, else one KV head per query head
      (a rank whose heads straddle two groups; the kernel is never handed
      a grouping it does not have);
    * for the flash kernel under ``seq_parallel`` (the training forward's
      sequence-parallel branch), the queries' sequence: rank r
      holds queries [r c, (r+1) c) and passes keys [0, (r+1) c + Sk -
      Sq), so the kernel's end alignment gives the global causal mask;
    * else nothing: every model peer computes every head.

    Where a rank uses a different part of a K or V that every model peer
    holds whole, its gradient is a partial sum over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    sizes = mesh_shape(mesh)
    names = list(sizes)
    n_model = sizes.get("model", 1)
    b, sq, h, _ = q.shape
    sk, kh = k.shape[1], k.shape[2]
    baxes = _axes_of(pspec_for((b,), ("batch",), mesh)[0])
    r = mesh.get_local_rank("model") if "model" in sizes else 0
    if n_model == 1:
        mode = "whole"
    elif h % n_model == 0:
        mode = "heads" if kh % n_model == 0 else "heads_kv_whole"
    elif flash and seq_parallel and sq % n_model == 0:
        mode = "seq"
    else:
        mode = "whole"

    def placements(model_dim, model_other=Replicate()):
        def one(a):
            if sizes[a] == 1:               # one rank: nothing to split
                return Replicate()
            if a in baxes:
                return Shard(0)
            if a != "model":
                return Replicate()
            return model_other if model_dim is None else Shard(model_dim)
        return tuple(one(a) for a in names)

    q_pl = placements({"heads": 2, "heads_kv_whole": 2, "seq": 1}.get(mode))
    kv_pl = placements(2 if mode == "heads" else None)
    kv_grad = (kv_pl if mode in ("heads", "whole")
               else placements(None, Partial()))
    g = h // kh

    def local(ql, kl, vl):
        if mode == "heads_kv_whole":
            hl = ql.shape[2]
            if hl % g == 0:
                lo = r * hl // g
                kl, vl = kl[:, :, lo:lo + hl // g], vl[:, :, lo:lo + hl // g]
            else:
                idx = (torch.arange(hl, device=kl.device) + r * hl) // g
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        elif mode == "seq":
            end = (r + 1) * ql.shape[1] + sk - sq
            kl, vl = kl[:, :end], vl[:, :end]
        if flash:
            return flash_attention(ql, kl, vl)
        return _xla_attention(ql, kl, vl, causal=causal, q_offset=q_offset,
                              kv_valid=kv_valid)

    fn = local_map(local, out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def _wants_seq_parallel(cfg) -> bool:
    """True under a mesh whose ``model`` axis the head count does not
    divide (qwen2-0.5b's 14 heads, qwen1.5-4b's 20): the attention
    weights replicate, so without further action every model peer
    computes the whole attention. The JAX package's fix: shard the
    QUERY sequence over ``model`` inside the attention block; K and V
    (small for GQA) are gathered."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh_shape(mesh):
        return False
    return cfg.n_heads % mesh_shape(mesh)["model"] != 0


def attention_train(p: dict, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, impl: str = "chunked",
                    use_rope: bool = True) -> torch.Tensor:
    """The training forward's attention: ``attention_prefill``'s
    arithmetic without a cache, and under a mesh that wants it
    (:func:`_wants_seq_parallel`) the JAX package's sequence-parallel
    layout: x and q over ``model`` along the sequence, k and v whole,
    the attention's output gathered back."""
    seq_par = _wants_seq_parallel(cfg)
    if seq_par:
        x = constrain(x, ("batch", "seq_sp", None))
    q, k, v = _qkv(p, x, rows_local=seq_par)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if seq_par:
        q = constrain(q, ("batch", "seq_sp", None, None))
        k = constrain(k, ("batch", None, None, None))
        v = constrain(v, ("batch", None, None, None))
    out = run_attention(q, k, v, causal=True, impl=impl,
                        seq_parallel=seq_par)
    if seq_par:
        # gathered over "model" before the output projection, not after
        # it (the JAX package's order): DTensor cannot split the
        # projection's weight gradient, laid out over its (H e) rows,
        # back into 14 or 7 heads
        out = constrain(out, ("batch", None, None, None))
    return _out(p, out)


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
