"""Chain decode on the device, and the delta narrowing rule.

Integer superlog fields stay chain-delta-packed on the device: the first
cell of every row chain raw, every later cell as a wraparound delta
against its predecessor, narrowed to the smallest int that holds every
delta. ``chain_decode`` reconstructs the values inside the gather path
(core/store.py). The JAX package leaves this scan to XLA
(``jax.lax.associative_scan``); the port leaves it to torch ops on the
store's device. A fused decode-at-index gather kernel is a later
optimization. The on-disk chain codec waits for the persistence slice.
"""
from __future__ import annotations

import numpy as np
import torch


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def chain_decode(deltas: torch.Tensor, heads: torch.Tensor, *,
                 xor: bool = False) -> torch.Tensor:
    """Decode chain deltas: deltas (C, W) int lanes where the first cell of
    every chain is raw and ``heads`` (C,) bool flags those cells.

    Add path: the segmented inclusive sum, reset at heads, in int32
    wraparound; the result is int32 and the caller truncates it to the
    stored dtype (which reproduces the JAX package's int32 scan byte for
    byte). It widens to int64, takes one cumsum per lane, and subtracts
    the running sum just before each cell's chain head (found by a cummax
    over the head positions); int64 holds the sums exactly, so the low 32
    bits are the int32 result. ``xor=True``: the segmented XOR scan in the
    lanes' own dtype, by log-step doubling (float lane chains; XOR is its
    own inverse)."""
    c = deltas.shape[0]
    heads = heads.reshape(-1).to(torch.bool)
    if c == 0:
        return deltas.to(deltas.dtype if xor else torch.int32)
    if xor:
        v, f = deltas, heads
        step = 1
        while step < c:
            # cell i absorbs cell i - step unless a head lies in between
            keep = f[step:].view((-1,) + (1,) * (v.ndim - 1))
            v = torch.cat([v[:step],
                           torch.where(keep, v[step:], v[step:] ^ v[:-step])])
            f = torch.cat([f[:step], f[step:] | f[:-step]])
            step *= 2
        return v
    # scan along the innermost dim: torch's scan over the outer dim of a
    # (C, W) tensor runs one thread per column, sequentially over C
    d = deltas.reshape(c, -1).t().to(torch.int64).contiguous()  # (W, C)
    cs = torch.cumsum(d, dim=1)
    pos = torch.arange(c, device=deltas.device)
    head_at, _ = torch.cummax(torch.where(heads, pos, 0), dim=0)
    before = torch.cat([cs.new_zeros((cs.shape[0], 1)), cs[:, :-1]], dim=1)
    out = _wrap32(cs - before[:, head_at])
    return out.t().contiguous().reshape(deltas.shape)


def narrow_dtype(maxabs: int, base=np.int32) -> type:
    """The narrowest int dtype that holds every delta of magnitude
    <= ``maxabs`` (``base`` when none of int8/16/32 does)."""
    if maxabs < 128:
        return np.int8
    if maxabs < 32768:
        return np.int16
    if maxabs < 2**31:
        return np.int32
    return base
