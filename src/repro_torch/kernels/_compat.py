"""Device resolution and small integer helpers shared by the kernels.

The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``resolve_device(None)`` is ``cuda``, and without a card it
raises rather than falling back, so a run never measures the wrong device
by accident.
"""
from __future__ import annotations

import threading

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
    if not (t.is_cuda or t.is_cpu):
        raise ValueError(f"{name} is on {t.device}; only cpu and cuda")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_launch_lock = threading.Lock()


def count_launch(wrapper, kind: str | None = None) -> None:
    """Add one to ``wrapper.launches`` (and to ``wrapper.by_design[kind]``
    where a wrapper has several kernels) under a lock: a sharded store's
    release session launches kernels from its per-shard worker threads,
    and ``+= 1`` on an attribute is not atomic across threads."""
    with _launch_lock:
        wrapper.launches += 1
        if kind is not None:
            wrapper.by_design[kind] += 1


# torch's own getter of the raw handle (what its compiled kernels call):
# a fraction of a microsecond, where building a ``torch.cuda.Stream`` takes
# several; absent from CPU-only builds, which launch nothing
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream on the card of ``t`` (a
    CUDA tensor, or a card's index)."""
    dev = t if isinstance(t, int) else t.get_device()
    if _raw_stream is not None:
        return _raw_stream(dev)
    return torch.cuda.current_stream(dev).cuda_stream


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
