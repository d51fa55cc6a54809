"""RWKV6 ("Finch") block: data-dependent per-channel decay, attention-free.

The JAX package's ``src/repro/models/rwkv.py`` in torch ops, the
recurrence aside. Per head (state S: a (Dk, Dv) matrix):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w_raw_t)) per (head, Dk) channel, kept as its log
(<= 0, f32) until the recurrence. On the served path
(``transformer.prefill`` and ``decode_step``) it is the hand-written
kernel ``csrc/wkv.cu`` (``kernels.ops.wkv``): the sequential recurrence
with S in registers, which the JAX package's chunked form adapts to the
TPU. The training forward (``train=True``) runs the chunked torch ops
(``kernels/ref.py``, re-exported here): within a chunk of ``CHUNK``
tokens the state maps S -> diag(w) S + kv compose by the log-depth scan
``affine_scan`` (the JAX package uses ``jax.lax.associative_scan``),
chunks chaining through an f32 carry of S, and autograd differentiates
them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ref
from ..kernels.ops import wkv
from ..kernels.ref import wkv_chunked, wkv_sequential  # noqa: F401
from ..sharding.rules import (constrain, is_dtensor, replicated,
                              scan_placements)
from .layers import ParamSpec

CHUNK = ref.WKV_CHUNK
LORA = 32
LORA_W = 64


def rwkv_time_spec(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dk = d // h
    # w0, wlora2, bonus and ln_x stay f32: the JAX package applies their
    # f32 masters in f32
    return {
        "mu_x": ParamSpec((d,), "zeros", axes=("embed",)),
        "mu": ParamSpec((5, d), "zeros", axes=(None, "embed")),  # w,k,v,r,g
        "lora1": ParamSpec((d, 5 * LORA), "small", axes=("embed", None)),
        "lora2": ParamSpec((5, LORA, d), "small",
                           axes=(None, None, "embed")),
        "w0": ParamSpec((d,), "zeros", matrix=False, axes=("embed",)),
        "wlora1": ParamSpec((d, LORA_W), "small", axes=("embed", None)),
        "wlora2": ParamSpec((LORA_W, d), "small", matrix=False,
                            axes=(None, "embed")),
        "bonus": ParamSpec((h, dk), "zeros", matrix=False,
                           axes=("heads", "head_dim")),
        "wr": ParamSpec((d, d), axes=("embed", "heads_flat")),
        "wk": ParamSpec((d, d), axes=("embed", "heads_flat")),
        "wv": ParamSpec((d, d), axes=("embed", "heads_flat")),
        "wg": ParamSpec((d, d), axes=("embed", "heads_flat")),
        "wo": ParamSpec((d, d), axes=("heads_flat", "embed")),
        "ln_x_scale": ParamSpec((d,), "ones", matrix=False,
                                axes=("embed",)),
        "ln_x_bias": ParamSpec((d,), "zeros", matrix=False,
                               axes=("embed",)),
    }


def rwkv_channel_spec(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), "zeros", axes=("embed",)),
        "mu_r": ParamSpec((d,), "zeros", axes=("embed",)),
        "wk": ParamSpec((d, f), axes=("embed", "mlp")),
        "wv": ParamSpec((f, d), axes=("mlp", "embed")),
        "wr": ParamSpec((d, d), axes=("embed", "embed_out")),
    }


class RWKVState(NamedTuple):
    s: torch.Tensor        # (B, H, Dk, Dv) wkv matrix state, f32
    shift_t: torch.Tensor  # (B, d) previous token's input to time-mix
    shift_c: torch.Tensor  # (B, d) previous token's input to channel-mix


def init_rwkv_state(cfg, batch: int, dtype=torch.float32,
                    device=None) -> RWKVState:
    d, h = cfg.d_model, cfg.n_heads
    dk = d // h
    return RWKVState(
        s=torch.zeros((batch, h, dk, dk), dtype=torch.float32,
                      device=device),
        shift_t=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_c=torch.zeros((batch, d), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """xx_t = x_{t-1} (zero, or the carried state, at t = 0). x: (B, L, d)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """RWKV6 data-dependent lerp -> [x_w, x_k, x_v, x_r, x_g]."""
    dx = xx - x
    z = x + dx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(z @ p["lora1"].to(x.dtype))              # (B, L, 5 LORA)
    # whole on the model axis under a mesh: 5 LORA columns laid out over
    # it do not split back into the 5 mixes (a no-op without one)
    lo = constrain(lo, ("batch", None, None)).unflatten(-1, (5, LORA))
    mix = torch.einsum("blsr,srd->bsld", lo, p["lora2"].to(x.dtype))
    return [x + dx * (p["mu"][i].to(x.dtype) + mix[:, i]) for i in range(5)]


def _decay(p, x_w):
    """log w_t (<= 0, f32): w_t = exp(-exp(w0 + lora(x_w))) in (0, 1)."""
    raw = p["w0"].float() + (
        torch.tanh(x_w @ p["wlora1"].to(x_w.dtype)).float()
        @ p["wlora2"].float())
    return -torch.exp(torch.clamp(raw, -8.0, 4.0))


def _wkv_sharded(scan, r, k, v, logw, u, s0):
    """``scan`` on DTensors by ``local_map``: each rank's batch rows (the
    data axes) and heads (``model``, where it divides H; else every model
    peer runs every head), the recurrence being per head. The bonus
    ``u`` reaches every batch row: its gradient is a partial sum over
    the data axes."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    pl = scan_placements(mesh, r.shape[0], r.shape[2])
    seq, state = pl(2), pl(1)
    fn = local_map(scan, out_placements=(seq, state),
                   in_placements=(seq, seq, seq, seq, pl(0, Replicate()),
                                  state),
                   in_grad_placements=(seq, seq, seq, seq,
                                       pl(0, Partial()), state),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(r, k, v, logw, u, replicated(s0, mesh))


def rwkv_time_mix(p, x, cfg, *, state: RWKVState | None = None,
                  chunked: bool = True, train: bool = False):
    """x: (B, L, d) -> (out, (new wkv state, new time shift)).
    ``train``: the training forward, whose recurrence is the chunked
    torch ops (autograd differentiates them); otherwise the WKV kernel's
    wrapper ``wkv`` (its plain version on the CPU). Either runs per rank
    under a mesh (``_wkv_sharded``)."""
    b, l, d = x.shape
    h = cfg.n_heads
    dk = d // h
    xx = _token_shift(x, None if state is None else state.shift_t)
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xx)
    logw = _decay(p, x_w).reshape(b, l, h, dk)
    r = (x_r @ p["wr"].to(x.dtype)).reshape(b, l, h, dk)
    k = (x_k @ p["wk"].to(x.dtype)).reshape(b, l, h, dk)
    v = (x_v @ p["wv"].to(x.dtype)).reshape(b, l, h, dk)
    g = F.silu(x_g @ p["wg"].to(x.dtype))
    s0 = (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
          if state is None else state.s)
    u = p["bonus"].float()
    if train:
        scan = wkv_chunked if chunked else wkv_sequential
    else:
        scan = functools.partial(wkv, chunked=chunked)
    if is_dtensor(r):
        scan = functools.partial(_wkv_sharded, scan)
    out, s = scan(r.float(), k.float(), v.float(), logw, u, s0)
    # per-head group norm (ln_x)
    mu = out.mean(-1, keepdim=True)
    var = ((out - mu) ** 2).mean(-1, keepdim=True)
    out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, l, d)
    out = out * p["ln_x_scale"].float() + p["ln_x_bias"].float()
    out = (out.to(x.dtype) * g) @ p["wo"].to(x.dtype)
    return out, (s, x[:, -1, :])


def rwkv_channel_mix(p, x, cfg, *, state: RWKVState | None = None):
    """x: (B, L, d) -> (out, new channel shift)."""
    xx = _token_shift(x, None if state is None else state.shift_c)
    xk = x + (xx - x) * p["mu_k"].to(x.dtype)
    xr = x + (xx - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["wk"].to(x.dtype)))
    out = torch.sigmoid(xr @ p["wr"].to(x.dtype)) * (k @ p["wv"].to(x.dtype))
    return out, x[:, -1, :]
