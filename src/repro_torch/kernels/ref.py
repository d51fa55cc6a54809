"""Plain torch versions of the port's kernels (and host oracles).

Each ``ref_*`` is the semantic ground truth of one kernel: the wrappers
run it for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against it on the card. They repeat the kernel's arithmetic and are
no yardstick of speed. Integer wraparound is done explicitly in int64
(``_wrap32``): torch makes no promise about signed int32 overflow.
"""
from __future__ import annotations

import numpy as np
import torch

from ._compat import cdiv, round_up

# ---------------------------------------------------------------------------
# fingerprint: 2x32-bit multiplicative (FNV-style) row hashing.
# ---------------------------------------------------------------------------

FNV1_INIT = np.int32(-2128831035)  # 0x811C9DC5 as int32
FNV1_MUL = np.int32(16777619)
FNV2_INIT = np.int32(-1442509163)  # arbitrary odd second basis
FNV2_MUL = np.int32(374761393)  # prime (from xxHash)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the same values wrapped to the int32 range (still
    int64): the two's-complement result of the int32 arithmetic."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def ref_fingerprint(lanes: torch.Tensor) -> torch.Tensor:
    """lanes: (N, W) int32 row lanes -> (N, 2) int32 fingerprints."""
    if lanes.ndim != 2 or lanes.dtype != torch.int32:
        raise ValueError(f"lanes must be (N, W) int32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    n, w = lanes.shape
    x = lanes.to(torch.int64)
    h1 = torch.full((n,), int(FNV1_INIT), dtype=torch.int64,
                    device=lanes.device)
    h2 = torch.full((n,), int(FNV2_INIT), dtype=torch.int64,
                    device=lanes.device)
    for j in range(w):
        xj = x[:, j]
        h1 = _wrap32((h1 ^ xj) * int(FNV1_MUL))
        h2 = _wrap32(h2 * int(FNV2_MUL)) ^ _wrap32(xj + (j + 1))
    # final mix; >> is an arithmetic shift on the signed value
    h1 = h1 ^ _wrap32(h2 << 13)
    h2 = h2 ^ (h1 >> 7)
    return torch.stack([h1, h2], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# masked_cumsum: cumulative count of (ts <= T), the scan behind
# get_version / get_increment (segmented last-cell-<=T selection).
# ---------------------------------------------------------------------------


def ref_masked_cumsum(ts: torch.Tensor, t_query: int) -> torch.Tensor:
    """ts: (C,) int32 -> (C,) int32 inclusive cumsum of (ts <= T)."""
    return torch.cumsum((ts <= int(t_query)).to(torch.int32), dim=0,
                        dtype=torch.int32)


def ref_batched_masked_cumsum(ts: torch.Tensor,
                              t_queries: torch.Tensor) -> torch.Tensor:
    """ts: (C,); t_queries: (Q,) -> (Q, C) int32 inclusive cumsum of
    (ts <= t_q), one row per query."""
    m = ts[None, :] <= t_queries.to(ts.dtype)[:, None]
    return torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32)


def ref_batched_version_select(log_vals, log_ts, row_ptr, t_queries):
    """Q-query segmented last-cell-with-ts<=T selection over a CSR log:
    returns (out (Q, N, W), found (Q, N))."""
    (q,) = t_queries.shape
    n = row_ptr.shape[0] - 1
    if log_ts.shape[0] == 0:
        return (torch.zeros((q, n) + tuple(log_vals.shape[1:]),
                            dtype=log_vals.dtype, device=log_vals.device),
                torch.zeros((q, n), dtype=torch.bool, device=log_vals.device))
    cum = ref_batched_masked_cumsum(log_ts, t_queries)
    cum0 = torch.cat([torch.zeros((q, 1), dtype=torch.int32,
                                  device=cum.device), cum], dim=1)
    lo = row_ptr[:-1].long()
    hi = row_ptr[1:].long()
    cnt = cum0[:, hi] - cum0[:, lo]
    found = cnt > 0
    idx = torch.clamp(lo[None, :] + cnt - 1, 0, log_ts.shape[0] - 1)
    out = torch.where(found[..., None], log_vals[idx],
                      torch.zeros((), dtype=log_vals.dtype,
                                  device=log_vals.device))
    return out, found


def ref_version_select(log_vals, log_ts, row_ptr, t_query: int):
    """Single-query form of ``ref_batched_version_select``:
    (out_vals (N, W), found (N,) bool)."""
    tq = torch.tensor([int(t_query)], dtype=torch.int32,
                      device=log_ts.device)
    out, found = ref_batched_version_select(log_vals, log_ts, row_ptr, tq)
    return out[0], found[0]


# ---------------------------------------------------------------------------
# keep mask: the compaction horizon mask plus survivor counts per tile.
# ---------------------------------------------------------------------------


def ref_keep_mask(ts: torch.Tensor, cutoff: int,
                  tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ts: (C,) int32 -> (keep (C,) int32 = ts > cutoff, counts
    (ceil(C / tile),) int32 survivors per tile)."""
    keep = (ts > int(cutoff)).to(torch.int32)
    (c,) = ts.shape
    padded = torch.cat([keep, keep.new_zeros(round_up(c, tile) - c)])
    return keep, padded.view(cdiv(c, tile), tile).sum(dim=1,
                                                      dtype=torch.int32)


# ---------------------------------------------------------------------------
# chain decode: host oracle of the segmented scan over chain deltas.
# ---------------------------------------------------------------------------


def ref_chain_decode(deltas: np.ndarray, heads: np.ndarray, *,
                     xor: bool = False) -> np.ndarray:
    """Host oracle for the device chain decode: sequential prefix op
    within each head-delimited chain (int path widened to int32 like the
    device scan; the caller truncates to the stored dtype)."""
    out = (deltas.copy() if xor
           else deltas.astype(np.int32))
    with np.errstate(over="ignore"):
        for i in range(1, len(out)):
            if not heads[i]:
                out[i] = (out[i] ^ out[i - 1]) if xor else out[i] + out[i - 1]
    return out
