"""Mamba (selective SSM) block for the Jamba hybrid architecture.

The JAX package's ``src/repro/models/ssm.py`` in torch ops, the scan
aside. On the served path (``transformer.prefill`` and ``decode_step``)
the recurrence h_t = a_t h_{t-1} + b_t (a_t = exp(dt_t A) in (0, 1], b_t =
dt_t B_t x_t) is the hand-written kernel ``csrc/ssm_scan.cu``
(``kernels.ops.ssm_scan``): the sequential recurrence with each channel's
states in registers, which the JAX package's chunked scan adapts to the
TPU. The training forward (``train=True``) runs the chunked torch ops
(``kernels/ref.py``, re-exported here): within a chunk of ``CHUNK``
tokens the affine maps h -> a h + b compose by a log-depth
(Hillis-Steele) scan, chunks chaining through an f32 carry of h, and
autograd differentiates them. The JAX package composes the same maps with
``jax.lax.associative_scan``, in another order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ref
from ..kernels.ops import ssm_scan
from ..kernels.ref import (ssm_scan_chunked,  # noqa: F401
                           ssm_scan_sequential)
from ..sharding.rules import (constrain, is_dtensor, replicated,
                              scan_placements)
from .layers import ParamSpec

CHUNK = ref.SSM_CHUNK


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


def _ssm_sharded(scan, dt, bmat, cmat, x1, a, h0):
    """``scan`` on DTensors by ``local_map``, as ``rwkv._wkv_sharded``
    runs the WKV recurrence: each rank's batch rows (the data axes) and
    d_inner channels (``model``, where it divides d_inner; else every
    model peer runs every channel), the recurrence being per channel; B
    and C reach every channel of a rank's rows. The served path's layout
    under a mesh (the dry run's prefill and decode cells); the training
    forward runs the chunked torch ops on the DTensors themselves."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = dt.device_mesh
    pl = scan_placements(mesh, dt.shape[0], dt.shape[2])
    seq, bc, state = pl(2), pl(None), pl(1)
    fn = local_map(scan, out_placements=(seq, state),
                   in_placements=(seq, bc, bc, seq, pl(0, Replicate()),
                                  state),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(dt, bmat, cmat, x1, a, replicated(h0, mesh))


def mamba_forward(p, x, cfg, *, state: SSMState | None = None,
                  chunked: bool = True, train: bool = False):
    """x: (B, L, d) -> (out (B, L, d), final SSMState). ``chunked``: a
    prefill (else one decode step); ``train``: the training forward,
    whose scan is the chunked torch ops (autograd differentiates them);
    otherwise the scan kernel's wrapper ``ssm_scan`` (its plain version on
    the CPU), per rank under a mesh."""
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
    if train:
        scan = ssm_scan_chunked if chunked else ssm_scan_sequential
    else:
        scan = functools.partial(ssm_scan, chunked=chunked)
        if is_dtensor(dt):
            scan = functools.partial(_ssm_sharded, scan)
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
