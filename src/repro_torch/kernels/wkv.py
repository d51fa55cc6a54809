"""RWKV6's WKV recurrence on the card: ``csrc/wkv.cu``.

Per batch row and head, with the state S a (Dk, Dk) matrix:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t

The kernel is the sequential recurrence with S in registers, the CUDA WKV
kernel whose loop the JAX package's chunked form adapts to the TPU
(``src/repro/models/rwkv.py:8-13``). The served path
(``models/rwkv.rwkv_time_mix`` under ``transformer.prefill`` and
``decode_step``) calls :func:`wkv`; the training forward runs the chunked
torch ops instead, which autograd differentiates. The plain versions are
``ref.wkv_chunked`` and ``ref.wkv_sequential``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
from torch.distributed.tensor import DTensor

from . import _build, ref
from ._compat import count_launch, stream_ptr

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
#: the head sizes the kernel is built for
HEAD_DIMS = (16, 64)


def _check(r, k, v, logw, u, s0) -> tuple[int, int, int, int]:
    """dtypes, shapes and devices of the recurrence's inputs: (B, L, H,
    Dk)."""
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: the recurrence runs on "
                            f"each rank's local tensors (models/rwkv.py, "
                            f"_wkv_sharded)")
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"r is on {dev}; only cpu and cuda")
    if r.ndim != 4 or r.shape[1] < 1:
        raise ValueError(f"r must be (B, L, H, Dk) with L >= 1, got "
                         f"{tuple(r.shape)}")
    b, l, h, dk = r.shape
    for name, t, shape in (("k", k, (b, l, h, dk)), ("v", v, (b, l, h, dk)),
                           ("logw", logw, (b, l, h, dk)), ("u", u, (h, dk)),
                           ("s0", s0, (b, h, dk, dk))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return b, l, h, dk


def wkv(r, k, v, logw, u, s0, *, chunked: bool = True):
    """r, k, v, logw: (B, L, H, Dk) f32; u: (H, Dk) f32; s0: (B, H, Dk, Dk)
    f32 -> (o (B, L, H, Dk) f32, S_L (B, H, Dk, Dk) f32).

    A CPU tensor takes the plain version: ``ref.wkv_chunked`` where
    ``chunked``, else ``ref.wkv_sequential``. A CUDA tensor launches the
    kernel whichever ``chunked`` is (and counts the launch in
    ``wkv.launches``); it raises for Dk outside :data:`HEAD_DIMS`, and
    where autograd would record the call (the kernel has no backward: the
    training forward runs the torch ops). Inputs are made contiguous (a
    copy only where they are not; the served path's are). A DTensor
    raises."""
    b, l, h, dk = _check(r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        scan = ref.wkv_chunked if chunked else ref.wkv_sequential
        return scan(r, k, v, logw, u, s0)
    if dk not in HEAD_DIMS:
        raise ValueError(f"the WKV kernel holds Dk in {HEAD_DIMS}, got {dk}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, s0)):
        raise RuntimeError("wkv has no backward: the training forward runs "
                           "the chunked torch ops (train=True)")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} over the kernel's grid")
    r, k, v, logw, u, s0 = (t.contiguous() for t in (r, k, v, logw, u, s0))
    o = torch.empty((b, l, h, dk), dtype=torch.float32, device=r.device)
    s = torch.empty((b, h, dk, dk), dtype=torch.float32, device=r.device)
    fn = _build.kernel_fn("wkv", "wkv_launch", _ARGS)
    # a decode step's call is launch-bound: switch devices only when the
    # inputs are not on the current one
    here = r.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(
            r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), s0.data_ptr(), o.data_ptr(), s.data_ptr(), b, l,
                h, dk, stream_ptr(r))
    _build.check(rc, "wkv", "wkv_launch")
    count_launch(wkv)
    return o, s


wkv.launches = 0
