"""Key -> shard routing (the scatter step of the sharded store).

The sharded store (``core/shard.py``) hash-partitions the entry keyspace
over N independent stores, as the paper spreads meta-database rows over
HBase region servers (§II.B/§V). The route is a *persistent* function of
the key alone: the same key lands on the same shard across releases,
processes, batch compositions and both packages, because a sharded
directory written by one package reopens in the other only if every key
routes the same (the routing version is written into the shard manifest).
The hash folds zero-padded little-endian key lanes with a zero-transparent
xor-rotate mix and tells real trailing zero bytes apart by the key length.

The fold is the CUDA kernel ``csrc/shard_route.cu`` (one thread per key),
with two entry points. ``route_keys`` hands the card every key's bytes
end to end in one flat buffer with (N + 1,) offsets (``key_bytes``: one
join and one cumsum on the host, no loop over keys), and the kernel
builds each key's lanes from them (``shard_route_bytes``; plain version
``ref.ref_shard_route_bytes``). ``shard_route`` takes padded (N, W) lanes
and byte lengths, as the JAX package's kernel does (``key_lanes`` packs
them on the host one key at a time; plain version ``ref.ref_shard_route``).
Both give the same ids for the same keys.

The gather step of scatter-gather is ``merge_shard_rows``: per-shard
global-row arrays are each ascending and mutually disjoint, so one argsort
over their concatenation gives the unsharded store's row order exactly.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build, ref
from ._compat import check_tensor, count_launch, stream_ptr
from .launch import check_tile, tile_for
from ..obs import kerneltel

#: routing-function version tag, persisted in shard manifests: a store
#: written under one tag must never be extended by a different hash.
ROUTING_VERSION = "xor-rotate-fold-v1"

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
_BYTES_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check_shards(n_shards) -> int:
    n_shards = int(n_shards)
    if not 1 <= n_shards < 2**31:
        raise ValueError(f"n_shards must be in [1, 2**31), got {n_shards}")
    return n_shards


def shard_route(lanes: torch.Tensor, lengths: torch.Tensor,
                n_shards: int) -> torch.Tensor:
    """lanes: (N, W) int32; lengths: (N,) int32 on the same device ->
    (N,) int32 shard ids in [0, n_shards).

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel, ``tile_for("shard_route", N)`` keys a block (and counts the
    launch in ``shard_route.launches``), or raises for a tile it cannot
    launch."""
    check_tensor(lanes, "lanes", torch.int32, 2)
    check_tensor(lengths, "lengths", torch.int32, 1)
    if lengths.device != lanes.device or lengths.shape[0] != lanes.shape[0]:
        raise ValueError(f"lengths {tuple(lengths.shape)} on "
                         f"{lengths.device} do not match lanes "
                         f"{tuple(lanes.shape)} on {lanes.device}")
    n_shards = _check_shards(n_shards)
    if lanes.device.type == "cpu":
        return ref.ref_shard_route(lanes, lengths, n_shards)
    n, w = lanes.shape
    tile = check_tile("shard_route", tile_for("shard_route", n=n,
                                               device=lanes.device))
    out = torch.empty(n, dtype=torch.int32, device=lanes.device)
    if n == 0:
        return out
    fn = _build.kernel_fn("shard_route", "shard_route_launch", _ARGS)
    here = lanes.get_device() == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(
            lanes.device):
        rc = fn(lanes.data_ptr(), lengths.data_ptr(), out.data_ptr(), n, w,
                n_shards, tile, stream_ptr(lanes))
    _build.check(rc, "shard_route", "shard_route_launch")
    count_launch(shard_route)
    return out


shard_route.launches = 0


def shard_route_bytes(flat: torch.Tensor, offsets: torch.Tensor,
                      n_shards: int) -> torch.Tensor:
    """flat: (B,) uint8, every key's bytes end to end; offsets: (N + 1,)
    int64 on the same device, key i = flat[offsets[i]:offsets[i + 1]]
    (non-decreasing, within [0, B]) -> (N,) int32 shard ids in
    [0, n_shards), the ids ``shard_route`` gives the same keys.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel, ``tile_for("shard_route", N)`` keys a block (and counts the
    launch in ``shard_route_bytes.launches``), or raises for a tile it
    cannot launch."""
    check_tensor(flat, "flat", torch.uint8, 1)
    check_tensor(offsets, "offsets", torch.int64, 1)
    if offsets.device != flat.device or offsets.shape[0] < 1:
        raise ValueError(f"offsets {tuple(offsets.shape)} on "
                         f"{offsets.device} must hold N + 1 >= 1 entries on "
                         f"{flat.device}")
    n_shards = _check_shards(n_shards)
    if flat.device.type == "cpu":
        return ref.ref_shard_route_bytes(flat, offsets, n_shards)
    n = offsets.shape[0] - 1
    tile = check_tile("shard_route", tile_for("shard_route", n=n,
                                               device=flat.device))
    out = torch.empty(n, dtype=torch.int32, device=flat.device)
    if n == 0:
        return out
    fn = _build.kernel_fn("shard_route", "shard_route_bytes_launch",
                          _BYTES_ARGS)
    here = flat.get_device() == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(flat.device):
        rc = fn(flat.data_ptr(), offsets.data_ptr(), out.data_ptr(), n,
                n_shards, tile, stream_ptr(flat))
    _build.check(rc, "shard_route", "shard_route_bytes_launch")
    count_launch(shard_route_bytes)
    return out


shard_route_bytes.launches = 0


# -- host plumbing ------------------------------------------------------------

def key_lanes(keys: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Pack byte keys into (lanes (N, W) int32, lengths (N,) int32): each
    key's bytes little-endian into 4-byte lanes, zero-padded to the batch
    max width (the hash is width-stable, so the batch max is a packing
    convenience, not part of the route). The input of ``shard_route``, as
    the JAX package packs it, one key at a time; ``route_keys`` does not
    call it (``key_bytes``)."""
    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), np.int32, count=n)
    wb = max((int(lens.max(initial=1)) + 3) // 4, 1) * 4
    buf = np.zeros((n, wb), np.uint8)
    for i, k in enumerate(keys):
        buf[i, : len(k)] = np.frombuffer(k, np.uint8)
    # explicit little-endian lane packing: the route (and therefore the
    # persisted partitioning) must not depend on host byte order
    lanes = buf.view("<u4").astype(np.uint32).view(np.int32)
    return lanes, lens


def key_bytes(keys: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Lay byte keys end to end: (flat (B,) uint8, offsets (N + 1,) int64),
    key i = flat[offsets[i]:offsets[i + 1]]. One join and one cumsum, no
    loop over keys in Python; ``flat`` is writable (torch takes it
    without a copy)."""
    n = len(keys)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, keys), np.int64, count=n),
              out=offsets[1:])
    return np.frombuffer(bytearray().join(keys), np.uint8), offsets


def route_keys(keys: Sequence[bytes], n_shards: int, device) -> np.ndarray:
    """Stable shard id per key, computed on ``device``: (N,) host int32 in
    [0, n_shards). One shard needs no hash."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not keys:
        return np.zeros(0, np.int32)
    if n_shards == 1:
        return np.zeros(len(keys), np.int32)
    flat, offsets = key_bytes(keys)
    n = len(keys)
    lanes = int(((np.diff(offsets) + 3) // 4).sum())
    # traffic model: read the key bytes and the (N + 1,) offsets, write
    # (N,) ids; arithmetic: ~8 integer ops per folded lane (a key folds
    # ceil(len / 4) lanes) + the 5-op finalizer per key. Nothing is padded
    with kerneltel.launch("shard_route", nbytes=flat.size + 8 * (n + 1)
                          + 4 * n, flops=8 * lanes + 5 * n):
        return shard_route_bytes(torch.as_tensor(flat, device=device),
                                 torch.as_tensor(offsets, device=device),
                                 int(n_shards)).cpu().numpy()


def merge_shard_rows(parts: Sequence[np.ndarray]) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """Gather step: K per-shard ascending global-row arrays -> (merged rows,
    gather order into their concatenation). Shards partition the row space,
    so one argsort over the concatenation reproduces the exact ascending
    row order the unsharded store would have produced."""
    cat = (np.concatenate(parts) if len(parts)
           else np.zeros(0, np.int64))
    order = np.argsort(cat, kind="stable")
    return cat[order], order
