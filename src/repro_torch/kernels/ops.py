"""The store's single door to the kernels (+ dtype plumbing).

``KERNELS`` names each hand-written CUDA kernel's wrapper; each wrapper
carries a ``launches`` count of the times it launched its kernel (CPU
tensors take the plain version and count nothing).
"""
from __future__ import annotations

import numpy as np
import torch

from . import launch, ref
from .batched_select import (batched_masked_cumsum, batched_version_select,
                             scan_bucket)
from .compact_rewrite import compact_rewrite, keep_mask, ref_compact_rewrite
from .delta_codec import chain_decode, narrow_dtype
from .fingerprint import fingerprint
from .version_select import masked_cumsum, version_select

__all__ = [
    "KERNELS", "batched_masked_cumsum", "batched_version_select",
    "chain_decode", "compact_rewrite", "fingerprint", "fingerprint_rows",
    "keep_mask", "launch", "masked_cumsum", "narrow_dtype", "ref",
    "ref_compact_rewrite", "scan_bucket", "to_int_lanes", "version_select",
]

#: kernel name -> the wrapper that launches it (and counts its launches)
KERNELS = {
    "fingerprint": fingerprint,
    "masked_cumsum": batched_masked_cumsum,
    "keep_mask": keep_mask,
}


def to_int_lanes(x, device) -> torch.Tensor:
    """View any fixed-width host row array (N, W) as int32 lanes (N, W')
    on ``device`` for fingerprinting.

    4-byte dtypes are reinterpreted bit for bit. 1- and 2-byte dtypes are
    SIGN-extended per element, exactly as the JAX package does
    (``view(int16).astype(int32)``): a uint16 65535 becomes the lane -1.
    (The JAX package's docstring says "zero-extended"; its code, which the
    fingerprints and digests follow, sign-extends.) 8-byte dtypes raise
    TypeError: the store refuses fields wider than 32 bits, and the JAX
    package, with 64-bit types off, silently narrows them before hashing."""
    x = np.ascontiguousarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if x.dtype.itemsize not in (1, 2, 4):
        raise TypeError(f"unsupported lane dtype {x.dtype}")
    signed = {1: np.int8, 2: np.int16, 4: np.int32}[x.dtype.itemsize]
    t = torch.as_tensor(np.ascontiguousarray(x).view(signed), device=device)
    return t.to(torch.int32)


def fingerprint_rows(x, device) -> np.ndarray:
    """Fingerprint arbitrary-dtype host rows on ``device``; returns host
    (N, 2) int32."""
    return fingerprint(to_int_lanes(x, device)).cpu().numpy()
