"""Mamba (selective SSM) block for the Jamba hybrid architecture.

The JAX package's ``src/repro/models/ssm.py`` in torch ops. Within a chunk
of ``CHUNK`` tokens the recurrence h_t = a_t h_{t-1} + b_t (a_t =
exp(dt_t A) in (0, 1], b_t = dt_t B_t x_t) is the composition of the
affine maps h -> a h + b, taken by a log-depth (Hillis-Steele) scan of
torch ops: log2(chunk) steps, each composing every map with the one
``2^i`` positions before it. No step divides by a cumulative product of
a, which would underflow. The JAX package composes the same maps with
``jax.lax.associative_scan``, in another order. Chunks chain through an
f32 carry of h, so the scan's intermediates are (B, CHUNK, d_inner, N),
not (B, L, d_inner, N). On the card these torch ops take most of a
Jamba prefill's device time (``chip_smoke.py``'s ``families_served``
profile); a scan kernel is queued in ROADMAP.md.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding.rules import constrain
from .layers import ParamSpec

CHUNK = 128


def ssm_spec(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    r = max(1, d // 16)
    # dt_proj, dt_bias, a_log and d_skip stay f32: the JAX package applies
    # their f32 masters in f32
    return {
        "in_proj": ParamSpec((d, 2 * di), axes=("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, di), scale=0.5,
                            axes=(None, "ssm_inner")),
        "conv_b": ParamSpec((di,), "zeros", axes=("ssm_inner",)),
        "x_proj": ParamSpec((di, r + 2 * n), axes=("ssm_inner", None)),
        "dt_proj": ParamSpec((r, di), matrix=False,
                             axes=(None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), "zeros", matrix=False,
                             axes=("ssm_inner",)),
        "a_log": ParamSpec((di, n), "zeros", matrix=False,
                           axes=("ssm_inner", None)),
        "d_skip": ParamSpec((di,), "ones", matrix=False,
                            axes=("ssm_inner",)),
        "out_proj": ParamSpec((di, d), axes=("ssm_inner", "embed")),
    }


class SSMState(NamedTuple):
    h: torch.Tensor      # (B, d_inner, N) f32
    conv: torch.Tensor   # (B, conv_w - 1, d_inner) trailing inputs


def init_ssm_state(cfg, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    di = cfg.ssm_expand * cfg.d_model
    return SSMState(
        h=torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                         device=device))


def affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix composition along dim 1 of the maps h -> a_t h +
    b_t (a broadcast against b's trailing dims): (A_t, B_t) with h_t =
    A_t h_0 + B_t. Log-depth: at step i each position composes its map
    with the one 2^i before it (the later map applied last)."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_hi = a[:, off:]
        b = torch.cat([b[:, :off], _times(a_hi, b[:, :-off]) + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a_hi * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _times(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a times b, a's dims a leading prefix of b's."""
    while a.ndim < b.ndim:
        a = a[..., None]
    return a * b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv by shifted adds. x: (B, L, di); w: (cw, di)."""
    cw = w.shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = b.to(x.dtype)
    l = x.shape[1]
    for i in range(cw):
        out = out + xp[:, i:i + l, :] * w[i].to(x.dtype)
    return out


def _a_matrix(p) -> torch.Tensor:
    # A = -exp(a_log) - 1: strictly negative (a_log init zeros -> A = -2)
    return -(torch.exp(p["a_log"].float()) + 1.0)


def _dt_bc(p, xc: torch.Tensor, cfg):
    """xc: (..., di) conv+silu output -> (dt (..., di), B (..., N), C
    (..., N)), f32."""
    r = max(1, cfg.d_model // 16)
    n = cfg.ssm_state
    dbl = xc @ p["x_proj"].to(xc.dtype)
    # whole on the model axis under a mesh before the split (a no-op
    # without one): the product over the sharded d_inner is a partial sum
    dbl = constrain(dbl, ("batch",) + (None,) * (dbl.ndim - 1))
    dt_low, bc, cc = torch.split(dbl, [r, n, n], dim=-1)
    raw = dt_low.float() @ p["dt_proj"].float() + p["dt_bias"].float()
    dt = torch.logaddexp(raw, torch.zeros((), device=raw.device))
    return dt, bc.float(), cc.float()


def ssm_scan_chunked(dt, bmat, cmat, x1, a, h0, *, chunk: int = CHUNK):
    """dt: (B, L, di); bmat/cmat: (B, L, N); x1: (B, L, di); a: (di, N);
    h0: (B, di, N). Returns (y (B, L, di) f32, h_final (B, di, N) f32)."""
    l = dt.shape[1]
    chunk = min(chunk, l)
    h = h0.float()
    ys = []
    for c0 in range(0, l, chunk):
        dtc = dt[:, c0:c0 + chunk]                       # (B, c, di)
        bc, cc = bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
        xc = x1[:, c0:c0 + chunk].float()
        la = dtc[..., None] * a                          # log decay <= 0
        binp = dtc[..., None] * bc[:, :, None, :] * xc[..., None]
        aa, bb = affine_scan(torch.exp(la), binp)
        h_t = aa * h[:, None] + bb                       # (B, c, di, N)
        ys.append(torch.einsum("bcn,bcdn->bcd", cc, h_t))
        h = h_t[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_scan_sequential(dt, bmat, cmat, x1, a, h0):
    """The plain per-token recurrence (the decode step, and the tests'
    reference)."""
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(dtt[..., None] * a)
        h = da * h + dtt[..., None] * bmat[:, t, None, :] \
            * x1[:, t].float()[..., None]
        ys.append(torch.einsum("bn,bdn->bd", cmat[:, t], h))
    return torch.stack(ys, dim=1), h


def mamba_forward(p, x, cfg, *, state: SSMState | None = None,
                  chunked: bool = True):
    """x: (B, L, d) -> (out (B, L, d), final SSMState)."""
    di = cfg.ssm_expand * cfg.d_model
    xz = x @ p["in_proj"].to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    hist = state.conv if state is not None else None
    xc = F.silu(_causal_conv(x1, p["conv_w"], p["conv_b"], hist))
    dt, bmat, cmat = _dt_bc(p, xc, cfg)
    a = _a_matrix(p)
    h0 = state.h if state is not None else torch.zeros(
        (x.shape[0], di, cfg.ssm_state), dtype=torch.float32,
        device=x.device)
    scan = ssm_scan_chunked if chunked else ssm_scan_sequential
    y, h_fin = scan(dt, bmat, cmat, xc, a, h0)
    y = y + p["d_skip"].float() * xc.float()
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"].to(x.dtype)
    cw = cfg.ssm_conv
    hist0 = (state.conv.to(x1.dtype) if state is not None else
             x1.new_zeros((x.shape[0], cw - 1, di)))
    tail = torch.cat([hist0, x1], dim=1)[:, -(cw - 1):, :]
    return out, SSMState(h=h_fin, conv=tail)


def mamba_decode(p, x, cfg, state: SSMState):
    """One-token step. x: (B, 1, d)."""
    return mamba_forward(p, x, cfg, state=state, chunked=False)
