"""Row fingerprints: the change-detection hash of every update.

``update`` compares each entry of a release against the stored head
version by a 2x32-bit fingerprint of its lanes rather than by its bytes.
The bits go into the release digest chain, so they equal the JAX
package's exactly. CUDA kernel: ``csrc/fingerprint.cu``; plain version:
``ref.ref_fingerprint``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._compat import check_tensor, stream_ptr
from .launch import tile_for

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


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
    with torch.cuda.device(lanes.device):
        rc = fn(lanes.data_ptr(), out.data_ptr(), n, w,
                tile_for("fingerprint"), stream_ptr(lanes))
    _build.check(rc, "fingerprint", "fingerprint_launch")
    fingerprint.launches += 1
    return out


fingerprint.launches = 0
