"""Device resolution and small integer helpers shared by the kernels.

The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``resolve_device(None)`` is ``cuda``, and without a card it
raises rather than falling back, so a run never measures the wrong device
by accident.
"""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; a string or ``torch.device`` as given.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present: pass ``device="cpu"`` to run the plain torch
    versions of the kernels on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain torch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_tensor(t, name: str, dtype: torch.dtype, ndim: int) -> None:
    """A kernel wrapper's input check: a contiguous ``ndim``-D ``dtype``
    tensor on the CPU or a CUDA card. Raises on anything else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{t.ndim}-D {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}; only cpu and cuda")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


_BITS = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def bits_view(arr: np.ndarray) -> np.ndarray:
    """View a fixed-width host array as the signed int of its item size.

    Device gathers move bits, not values, and torch implements
    ``index_select`` for signed ints and floats but not for uint16/uint32;
    going through the signed view keeps every stored dtype gatherable and
    bit-exact. ``from_bits`` undoes it on the host."""
    arr = np.ascontiguousarray(arr)
    return arr.view(_BITS[arr.dtype.itemsize])


def truncate_bits(t: torch.Tensor, itemsize: int) -> torch.Tensor:
    """int32 tensor -> its low ``itemsize`` bytes as the signed int of
    that width (two's-complement wraparound, computed exactly rather than
    left to the narrowing cast)."""
    if itemsize == 4:
        return t
    bits = 8 * itemsize
    sign = 1 << (bits - 1)
    low = ((t & ((1 << bits) - 1)) ^ sign) - sign
    return low.to({1: torch.int8, 2: torch.int16}[itemsize])


def from_bits(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """Host numpy copy of a ``bits_view`` tensor, viewed back as ``dtype``."""
    return np.ascontiguousarray(t.cpu().numpy()).view(dtype)
