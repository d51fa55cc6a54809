"""Row fingerprints: the change-detection hash of every update.

``update`` compares each entry of a release against the stored head
version by a 2x32-bit fingerprint of its lanes rather than by its bytes.
The bits go into the release digest chain, so they equal the JAX
package's exactly. CUDA kernel: ``csrc/fingerprint.cu``; plain version:
``ref.ref_fingerprint``. :func:`fingerprint_plan` is the kernel's launch
geometry, a plain function the CPU tests check.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from . import _build, ref
from ._compat import check_tensor, count_launch, stream_ptr

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_void_p]
PATHS = ("rows", "tile16", "tile4")  # the launcher's path codes, in order
ROWS_MAX_W = 8          # rows of at most 32 bytes take the rows path
ROWS_THREADS = 128      # rows path: threads per block
ROWS_PER_THREAD = 4     # rows path: rows a thread folds at once
TILE_BYTES = 32768      # tile paths: target bytes of one staged tile
CHUNK_LANES = 128       # tile paths: most lanes of a row staged at once
MIN_ROWS, MAX_ROWS = 32, 256  # tile paths: rows (threads) per tile
STAGES = 2              # tile paths: tiles in shared memory per block


@dataclasses.dataclass(frozen=True)
class FingerprintPlan:
    """How the kernel cuts an (N, W) fingerprint. ``path``: "rows" (W <=
    8: each thread folds ``ROWS_PER_THREAD`` rows straight from global
    memory), "tile16" (row tiles staged through shared memory in 16-byte
    pieces: W % 4 == 0 and a 16-byte aligned base) or "tile4" (the same
    in 4-byte words). A block of ``threads`` threads folds
    ``rows_per_tile`` rows per step; a tile path stages ``lanes_per_chunk``
    lanes of each row at a time, a row ``row_stride`` words apart in
    shared memory (odd 16-byte pieces or odd words), ``stages`` tiles
    deep, ``smem_bytes`` in all."""
    path: str
    rows_per_tile: int
    stages: int
    threads: int
    lanes_per_chunk: int
    row_stride: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def fingerprint_plan(w: int, base_align: int) -> FingerprintPlan:
    """The plan for rows of ``w`` int32 lanes whose base lies
    ``base_align`` bytes past a 16-byte boundary. The row count does not
    enter: the kernel's grid is persistent (as many blocks as the card
    holds at once, capped by the tiles) and masks its ragged last tile."""
    if w <= ROWS_MAX_W:
        return FingerprintPlan("rows", ROWS_THREADS * ROWS_PER_THREAD, 0,
                               ROWS_THREADS, w, 0, 0)
    vec16 = w % 4 == 0 and base_align % 16 == 0
    k = min(w, CHUNK_LANES)
    stride = 4 * ((k // 4) | 1) if vec16 else k | 1
    rows = min(MAX_ROWS, max(MIN_ROWS, TILE_BYTES // (4 * k) // 32 * 32))
    return FingerprintPlan("tile16" if vec16 else "tile4", rows, STAGES,
                           rows, k, stride, STAGES * rows * stride * 4)


@functools.lru_cache(maxsize=256)
def _launch_args(w: int, base_align: int):
    """The launcher's plan as one long long array (built once per
    width and alignment)."""
    p = fingerprint_plan(w, base_align)
    vals = (w, PATHS.index(p.path), p.threads, p.rows_per_tile,
            p.lanes_per_chunk, p.row_stride, p.smem_bytes)
    return (ctypes.c_longlong * len(vals))(*vals)


def fingerprint(lanes: torch.Tensor) -> torch.Tensor:
    """lanes: (N, W) int32 -> (N, 2) int32 row fingerprints.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the launch in ``fingerprint.launches``)."""
    check_tensor(lanes, "lanes", torch.int32, 2)
    if lanes.device.type == "cpu":
        return ref.ref_fingerprint(lanes)
    n, w = lanes.shape
    out = torch.empty((n, 2), dtype=torch.int32, device=lanes.device)
    if n == 0:
        return out
    fn = _build.kernel_fn("fingerprint", "fingerprint_launch", _ARGS)
    args = _launch_args(w, lanes.data_ptr() % 16)
    here = lanes.get_device() == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(
            lanes.device):
        rc = fn(lanes.data_ptr(), out.data_ptr(), n, args, stream_ptr(lanes))
    _build.check(rc, "fingerprint", "fingerprint_launch")
    count_launch(fingerprint)
    return out


fingerprint.launches = 0
