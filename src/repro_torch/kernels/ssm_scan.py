"""Mamba's selective scan on the card: ``csrc/ssm_scan.cu``.

For every batch row b and channel d of d_inner, from h_0 = h0[b, d]:

    h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + dt_t x_t B_t[n]
    y_t    = sum_n C_t[n] h_t[n]

The kernel is the sequential recurrence with each channel's states in
registers, the CUDA selective-scan kernel that the JAX package's chunked
scan adapts to the TPU (``src/repro/models/ssm.py:3-12``). The served
path (``models/ssm.mamba_forward`` under ``transformer.prefill`` and
``decode_step``) calls :func:`ssm_scan`; the training forward runs the
chunked torch ops instead, which autograd differentiates. The plain
versions are ``ref.ssm_scan_chunked`` (a prefill) and
``ref.ssm_scan_sequential`` (a decode step).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
from torch.distributed.tensor import DTensor

from . import _build, ref
from ._compat import count_launch, stream_ptr

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 \
    + [ctypes.c_void_p]
#: the state sizes the kernel is built for (its lanes hold 2 states each)
STATES = (8, 16)
#: the dtypes of x the kernel reads as they are
X_DTYPES = (torch.float32, torch.bfloat16)


def _check(dt, bmat, cmat, x, a, h0) -> tuple[int, int, int, int]:
    """dtypes, shapes and devices of the scan's inputs: (B, L, di, N)."""
    dev = dt.device
    for name, t in (("dt", dt), ("bmat", bmat), ("cmat", cmat), ("x", x),
                    ("a", a), ("h0", h0)):
        if isinstance(t, DTensor):
            raise TypeError(f"{name} is a DTensor: the scan runs on each "
                            f"rank's local tensors (models/ssm.py, "
                            f"_ssm_sharded)")
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, dt on {dev}")
        want = X_DTYPES if name == "x" else (torch.float32,)
        if t.dtype not in want:
            raise ValueError(f"{name} must be {' or '.join(map(str, want))}"
                             f", got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dt is on {dev}; only cpu and cuda")
    if dt.ndim != 3 or dt.shape[1] < 1:
        raise ValueError(f"dt must be (B, L, d_inner) with L >= 1, got "
                         f"{tuple(dt.shape)}")
    b, l, di = dt.shape
    if a.ndim != 2 or a.shape[0] != di:
        raise ValueError(f"a must be ({di}, N), got {tuple(a.shape)}")
    n = a.shape[1]
    for name, t, shape in (("bmat", bmat, (b, l, n)), ("cmat", cmat, (b, l, n)),
                           ("x", x, (b, l, di)), ("h0", h0, (b, di, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return b, l, di, n


def ssm_scan(dt, bmat, cmat, x, a, h0, *, chunked: bool = True):
    """dt: (B, L, di) f32; bmat, cmat: (B, L, N) f32; x: (B, L, di) f32 or
    bf16; a: (di, N) f32; h0: (B, di, N) f32 -> (y (B, L, di) f32, h_L (B,
    di, N) f32).

    A CPU tensor takes the plain version: ``ref.ssm_scan_chunked`` where
    ``chunked`` (a prefill), else ``ref.ssm_scan_sequential`` (a decode
    step). A CUDA tensor launches the kernel whichever ``chunked`` is (and
    counts the launch in ``ssm_scan.launches``); it raises for N outside
    :data:`STATES`, and where autograd would record the call (the kernel
    has no backward: the training forward runs the torch ops). bmat and
    cmat are read through their batch and time strides, as
    ``torch.split`` leaves them in an f32 model, where each row of N is
    contiguous (else they are copied); dt, x, a and h0 are made
    contiguous (a copy only where they are not). A DTensor raises."""
    b, l, di, n = _check(dt, bmat, cmat, x, a, h0)
    if dt.device.type == "cpu":
        scan = ref.ssm_scan_chunked if chunked else ref.ssm_scan_sequential
        return scan(dt, bmat, cmat, x, a, h0)
    if n not in STATES:
        raise ValueError(f"the scan kernel holds N in {STATES}, got {n}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bmat, cmat, x, a, h0)):
        raise RuntimeError("ssm_scan has no backward: the training forward "
                           "runs the chunked torch ops (train=True)")
    if b > 65535:
        raise ValueError(f"batch {b} over the kernel's grid")
    dt, x, a, h0 = (t.contiguous() for t in (dt, x, a, h0))
    bmat, cmat = (t if t.stride(2) == 1 else t.contiguous()
                  for t in (bmat, cmat))
    y = torch.empty((b, l, di), dtype=torch.float32, device=dt.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=dt.device)
    fn = _build.kernel_fn("ssm_scan", "ssm_scan_launch", _ARGS)
    # a decode step's call is launch-bound: switch devices only when the
    # inputs are not on the current one
    here = dt.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(
            dt.device):
        rc = fn(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(),
                cmat.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h.data_ptr(), b, l, di, n, int(x.dtype == torch.bfloat16),
                bmat.stride(0), bmat.stride(1), cmat.stride(0),
                cmat.stride(1), stream_ptr(dt))
    _build.check(rc, "ssm_scan", "ssm_scan_launch")
    count_launch(ssm_scan)
    return y, h


ssm_scan.launches = 0
