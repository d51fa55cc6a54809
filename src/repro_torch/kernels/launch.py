"""Launch tiles and shape buckets for the port's kernels: the JAX
package's tile resolution (``src/repro/kernels/launch.py``), keyed by the
card.

  * **Tile resolution** (:func:`tile_for`): ``GESTORE_TILE_<KERNEL>`` env
    override > autotuned winner from the on-disk cache for (kernel,
    device, pow2 bucket of n) > ``DEFAULT_TILES``. The override is the
    JAX package's own variable, so one environment gives both packages
    the same tiles; where a tile shapes an answer (the codec's per-tile
    stats, the keep mask's per-tile counts, the scan's bucket floor and
    with it the store's device bytes) both then write the same bytes.
  * **Winner cache**: the port's own file, ``GESTORE_TORCH_TILE_CACHE``
    (default ``~/.cache/gestore/tiles_torch.json``), keyed
    ``kernel/cuda:<card name>/bN`` or ``kernel/cpu/bN``: a winner timed on
    one card is never applied on another, nor taken from the JAX
    package's file (whose keys name a JAX backend).
  * **Autotune sweep** (:func:`sweep`): explicit, never implicit; a
    serving path only reads the cache.

Where the tile is only launch geometry (keys per block for the route,
cells per block for the keep mask), the kernel launches the resolved tile
or raises, naming the variable (:func:`check_tile`); nothing clamps it.
The scan kernel's own tile is a compile-time constant of its source
(``batched_select.TILE``): the ``batched_select`` tile floors its cell
buckets only. The fingerprint, the masked merge, chain decode and flash
attention size their blocks by their plans. The kernels mask their own
ragged last tile, so nothing pads inputs to a tile multiple.
"""
from __future__ import annotations

import json
import os
import threading

import torch

from ._compat import resolve_device

#: built-in tiles, the JAX package's: the codec's rows per stat tile and
#: the keep mask's cells per count must match its answers
DEFAULT_TILES = {
    "batched_select": 2048,   # cells: the floor of the scan's buckets
    "shard_route": 512,       # keys per block, one thread per key
    "delta_codec": 512,       # rows per stat tile (``codec_plan``)
    "compact_rewrite": 512,   # cells per block of the keep mask, 4 a thread
}

#: default sweep candidates per kernel, the JAX package's; :func:`sweep`
#: times those the kernel can launch
SWEEP_CANDIDATES = {
    "batched_select": (512, 1024, 2048, 4096),
    "shard_route": (256, 512, 1024, 2048),
    "delta_codec": (256, 512, 1024, 2048),
    "compact_rewrite": (256, 512, 1024, 2048),
}

ENV_PREFIX = "GESTORE_TILE_"
CACHE_ENV = "GESTORE_TORCH_TILE_CACHE"

#: kernel -> (can it launch this tile, what it needs): the route runs one
#: thread per key, at most 1,024 a block; the keep mask 4 cells a thread
#: in whole warps (its block sum), at most 1,024 threads; a codec tile
#: of any row count launches (``codec_plan`` checks its chunks)
_LAUNCHABLE = {
    "shard_route": (lambda t: 1 <= t <= 1024,
                    "keys per block, one thread each: 1 to 1,024"),
    "compact_rewrite": (lambda t: 0 < t <= 4096 and t % 128 == 0,
                        "cells per block, 4 a thread in whole warps: a "
                        "multiple of 128 up to 4,096"),
}

_lock = threading.Lock()
#: in-memory mirror of the on-disk winner cache; None = not loaded yet.
_winners: dict[str, int] | None = None


# -- shape buckets ------------------------------------------------------------

def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) (and >= 1)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


# -- tile resolution ----------------------------------------------------------

def cache_path() -> str:
    """Location of the port's on-disk autotune winner cache."""
    p = os.environ.get(CACHE_ENV, "").strip()
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "gestore",
                        "tiles_torch.json")


def platform(device=None) -> str:
    """The cache's name of a device: ``cpu``, or ``cuda:<card name>``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(dev)}"


def _cache_key(kernel: str, bucket: int, device=None) -> str:
    return f"{kernel}/{platform(device)}/b{int(bucket)}"


def _load_winners() -> dict[str, int]:
    global _winners
    with _lock:
        if _winners is None:
            _winners = {}
            try:
                with open(cache_path()) as f:
                    raw = json.load(f)
                _winners = {str(k): int(v) for k, v in raw.items()
                            if isinstance(v, (int, float))}
            except (OSError, ValueError, TypeError, AttributeError):
                pass  # missing or corrupt cache: start empty
        return _winners


def reset_cache() -> None:
    """Drop the in-memory winner mirror (tests / env changes re-read disk)."""
    global _winners
    with _lock:
        _winners = None


def record_winner(kernel: str, bucket: int, tile: int, device=None) -> None:
    """Persist an autotuned winner for ``device`` (None: the CUDA card) to
    memory and the on-disk cache (best effort: an unwritable cache
    directory degrades to in-memory only)."""
    key = _cache_key(kernel, bucket, device)
    winners = _load_winners()
    with _lock:
        winners[key] = int(tile)
        payload = dict(winners)
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def tile_for(kernel: str, n: int | None = None, device=None) -> int:
    """The launch tile of ``kernel`` for a leading axis of ``n`` on
    ``device`` (None: the CUDA card; read only to look a winner up).

    Precedence: ``GESTORE_TILE_<KERNEL>`` (a positive int; anything else
    is ignored, as in the JAX package) > the winner for (kernel, device,
    pow2 bucket of n) > ``DEFAULT_TILES``."""
    env = os.environ.get(ENV_PREFIX + kernel.upper(), "").strip()
    if env:
        try:
            t = int(env)
            if t > 0:
                return t
        except ValueError:
            pass  # malformed override: fall through to cache/default
    if n is not None:
        w = _load_winners().get(_cache_key(kernel, pow2_bucket(n), device))
        if w:
            return w
    return DEFAULT_TILES.get(kernel, 512)


def launchable(kernel: str, tile: int) -> bool:
    """Whether ``kernel``'s launch takes ``tile`` (any positive tile for a
    kernel whose tile is no launch geometry)."""
    ok, _ = _LAUNCHABLE.get(kernel, (lambda t: t > 0, ""))
    return bool(ok(int(tile)))


def check_tile(kernel: str, tile: int) -> int:
    """``tile``, or ValueError naming ``GESTORE_TILE_<KERNEL>`` where the
    kernel cannot launch it (no clamp)."""
    if not launchable(kernel, tile):
        need = _LAUNCHABLE.get(kernel, (None, "a positive tile"))[1]
        raise ValueError(
            f"{kernel}: cannot launch a tile of {tile} ({need}); set "
            f"{ENV_PREFIX}{kernel.upper()} or the winner cache "
            f"({CACHE_ENV}) to a tile it can launch")
    return int(tile)


# -- autotune sweep -----------------------------------------------------------

def sweep(kernel: str, bench, *, n: int, candidates=None,
          force: bool = False, device=None) -> dict:
    """Time ``bench(tile) -> wall_seconds`` over candidate tiles and persist
    the winner for this (kernel, device, bucket of n); ``device`` None is
    the CUDA card.

    Never called implicitly from a serving path. With a cached winner and
    ``force=False`` the sweep is skipped. ``candidates`` None takes
    ``SWEEP_CANDIDATES`` less those the kernel cannot launch; a given
    candidate it cannot launch raises (:func:`check_tile`).

    Returns ``{"tile", "bucket", "cached", "walls"}`` where ``walls`` maps
    tile -> measured seconds (empty when the cache answered).
    """
    bucket = pow2_bucket(n)
    if not force:
        w = _load_winners().get(_cache_key(kernel, bucket, device))
        if w:
            return {"tile": w, "bucket": bucket, "cached": True, "walls": {}}
    if candidates is None:
        cands = [t for t in SWEEP_CANDIDATES.get(kernel, (256, 512, 1024,
                                                          2048))
                 if launchable(kernel, t)]
    else:
        cands = [check_tile(kernel, t) for t in candidates]
    walls = {int(t): float(bench(int(t))) for t in cands}
    best = min(walls, key=walls.get)
    record_winner(kernel, bucket, best, device)
    return {"tile": best, "bucket": bucket, "cached": False, "walls": walls}
