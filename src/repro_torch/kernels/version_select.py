"""Single-version masked cumsum and CSR version select.

GeStore materializes version T by selecting, for every row's cell chain,
the newest cell with ts <= T (paper §III.C). With the cell log in CSR
order (sorted by (row, ts)) the per-row answer index is
``row_ptr[i] + count(ts_segment <= T) - 1``, a difference of the global
inclusive cumsum of the mask (ts <= T) at segment boundaries. The cumsum
is the batched kernel (``batched_select.py``) at one query.
"""
from __future__ import annotations

import torch

from .batched_select import batched_masked_cumsum, batched_version_select

_I32 = (-(2**31), 2**31 - 1)


def _query(t_query: int, device) -> torch.Tensor:
    t = int(t_query)
    if not _I32[0] <= t <= _I32[1]:
        raise ValueError(f"query timestamp {t} outside int32")
    return torch.tensor([t], dtype=torch.int32, device=device)


def masked_cumsum(ts: torch.Tensor, t_query: int) -> torch.Tensor:
    """ts: (C,) int32 -> (C,) int32 inclusive cumsum of (ts <= t_query)."""
    return batched_masked_cumsum(ts, _query(t_query, ts.device))[0]


def version_select(log_vals: torch.Tensor, log_ts: torch.Tensor,
                   row_ptr: torch.Tensor, t_query: int):
    """CSR segmented last-cell-with-ts<=T selection:
    (out_vals (N, W), found (N,) bool)."""
    out, found = batched_version_select(log_vals, log_ts, row_ptr,
                                        _query(t_query, log_ts.device))
    return out[0], found[0]
