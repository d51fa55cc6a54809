"""Launch shapes for the port's kernels: block tiles and shape buckets.

The JAX package resolves its Pallas tiles through an env override and an
autotuned winner cache; the port has one block size per kernel for now
(``DEFAULT_TILES``), and the sweep waits until there is a benchmark to
tune against. The kernels mask their own ragged last tile, so nothing
pads inputs to a tile multiple.
"""
from __future__ import annotations

#: elements per block (shard_route: keys per block; delta_codec: rows per
#: stat tile, which ``codec_plan`` cuts into blocks). Each is a multiple
#: of the kernel's items per thread and at most 1024 threads' worth. The
#: scan's and the flash attention kernel's tiles are compile-time
#: constants of their sources (the scan's: ``batched_select.TILE``); the
#: fingerprint, the masked merge and chain decode size their blocks by
#: their plans (``fingerprint_plan``, ``merge_plan``, ``decode_at_plan``).
DEFAULT_TILES = {
    "keep_mask": 1024,      # 256 threads x 4 cells
    "shard_route": 512,     # one thread per key; the JAX package's tile
    "delta_codec": 512,     # rows per stat tile; the JAX package's tile,
                            # so the per-tile stats match
}


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) (and >= 1)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def tile_for(kernel: str) -> int:
    """The block tile of ``kernel`` (KeyError for an unknown kernel)."""
    return DEFAULT_TILES[kernel]
