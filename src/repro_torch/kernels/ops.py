"""The package's single door to the kernels (+ dtype plumbing).

``KERNELS`` names each hand-written CUDA kernel's wrapper; each wrapper
carries a ``launches`` count of the times it launched its kernel (CPU
tensors take the plain version and count nothing). ``batched_masked_cumsum``
and ``stacked_masked_cumsum`` launch the same CUDA kernel with one row and
with S rows, and count apart, so a run shows which form its path took;
so do ``shard_route`` (padded lanes) and ``shard_route_bytes`` (flat key
bytes, the sharded store's route).
"""
from __future__ import annotations

import numpy as np
import torch

from . import launch, ref
from .batched_select import (batched_masked_cumsum, batched_version_select,
                             scan_bucket, stacked_boundary_select,
                             stacked_masked_cumsum)
from .compact_rewrite import compact_rewrite, keep_mask, ref_compact_rewrite
from .delta_codec import (chain_decode, chain_decode_at, chain_pack,
                          chain_unpack, delta_pack, delta_pack_wide,
                          delta_unpack, delta_unpack_wide, narrow_dtype,
                          ref_chain_decode_at)
from .fingerprint import fingerprint
from .flash_attention import (flash_attention, flash_bwd_delta, flash_bwd_dkdv,
                              flash_bwd_dq)
from .masked_merge import masked_merge
from .shard_route import (key_bytes, key_lanes, merge_shard_rows, route_keys,
                          shard_route, shard_route_bytes)
from .ssm_scan import ssm_scan
from .version_select import masked_cumsum, version_select
from .wkv import wkv

__all__ = [
    "KERNELS", "batched_masked_cumsum", "batched_version_select",
    "chain_decode", "chain_decode_at", "chain_pack", "chain_unpack",
    "compact_rewrite",
    "delta_pack", "delta_pack_wide", "delta_unpack", "delta_unpack_wide",
    "fingerprint", "fingerprint_rows", "flash_attention", "flash_bwd_delta",
    "flash_bwd_dkdv", "flash_bwd_dq", "keep_mask",
    "key_bytes", "key_lanes", "launch", "masked_cumsum", "masked_merge",
    "merge_shard_rows", "narrow_dtype", "ref", "ref_chain_decode_at",
    "ref_compact_rewrite", "route_keys", "scan_bucket", "shard_route",
    "shard_route_bytes", "ssm_scan", "stacked_boundary_select",
    "stacked_masked_cumsum", "to_int_lanes", "version_select", "wkv",
]

#: kernel name -> the wrapper that launches it (and counts its launches)
KERNELS = {
    "fingerprint": fingerprint,
    "masked_cumsum": batched_masked_cumsum,
    "stacked_masked_cumsum": stacked_masked_cumsum,
    "shard_route": shard_route,
    "shard_route_bytes": shard_route_bytes,
    "keep_mask": keep_mask,
    "delta_pack": delta_pack,
    "delta_unpack": delta_unpack,
    "delta_pack_wide": delta_pack_wide,
    "delta_unpack_wide": delta_unpack_wide,
    "masked_merge": masked_merge,
    "flash_attention": flash_attention,
    "flash_bwd_delta": flash_bwd_delta,
    "flash_bwd_dkdv": flash_bwd_dkdv,
    "flash_bwd_dq": flash_bwd_dq,
    "chain_decode": chain_decode_at,
    "ssm_scan": ssm_scan,
    "wkv": wkv,
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
