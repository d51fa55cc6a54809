"""Fused masked merge (increment application, paper §III.A/F).

Merging an incremental result back into the head table is a fused
(row-mask AND field-mask) select plus timestamp stamping: one streaming
pass over (N, W) instead of three (select, exists update, ts update). Row
alignment (the scatter of the compacted increment onto the row space) is
done by the caller; the kernel owns the wide data movement.

The kernel is ``csrc/masked_merge.cu``; its plain version is
``ref.ref_masked_merge``. Both move bits, so every dtype of 1, 2, 4 or 8
bytes merges exactly. The JAX package runs without 64-bit types, so its
int64 ``ts_base`` silently becomes int32; the port keeps ``ts_base``'s
dtype (int32 or int64) and returns it. :func:`merge_plan` is the
kernel's launch geometry and :func:`merge_nbytes` the bytes its bound
counts; both are plain functions the CPU tests check.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build, ref
from ._compat import count_launch, stream_ptr

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
_TS_DTYPES = (torch.int32, torch.int64)
THREADS = 256  # per block
UNITS_PER_BLOCK = 2048  # a block's units: 8 per thread
MAX_ROWS_PER_BLOCK = 8192  # the kernel's shared row-mask bytes


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """How the kernel cuts an (N, W) merge: each thread moves
    ``vec_bytes`` of a row at once (16 on rows of whole 16-byte vectors,
    down to one element), and a block of ``threads`` threads owns
    ``rows_per_block`` rows."""
    vec_bytes: int
    threads: int
    rows_per_block: int


def merge_plan(base: torch.Tensor, upd: torch.Tensor) -> MergePlan:
    """The widest unit of 16, 8, 4 or 2 bytes (or one element) that
    divides a row's W * s bytes and to which ``base`` and ``upd`` are
    aligned (the output is a fresh allocation, aligned to more), so that
    no unit crosses a row; and as many rows per block as make
    ``UNITS_PER_BLOCK`` units (at least one row, at most
    ``MAX_ROWS_PER_BLOCK``)."""
    s = base.element_size()
    row = base.shape[1] * s
    vec = next(v for v in (16, 8, 4, 2, s)
               if v >= s and row % v == 0 and base.data_ptr() % v == 0
               and upd.data_ptr() % v == 0)
    units = row // vec
    rows = min(MAX_ROWS_PER_BLOCK, max(1, UNITS_PER_BLOCK // max(units, 1)))
    return MergePlan(vec, THREADS, rows)


def merge_nbytes(row_mask: torch.Tensor, field_mask: torch.Tensor,
                 elem_size: int, ts_size: int) -> dict:
    """Bytes a merge at these masks must move, for its bound.

    ``"mask_aware"``: each output element needs the one operand element
    the masks select (N * W * s bytes read however the masks fall), the
    N * W * s bytes written, the N + W mask bytes, ``ts_base`` only for
    the rows that keep their timestamp, and the N timestamps written.
    Where the field mask is all true or all false (the head-table
    merge's: all true), that is ``base`` for every row not wholly taken
    and ``upd`` for every merged row that takes a field, which is what
    the kernel reads. ``"both_operands"``: both operands and every
    timestamp read, as a select that reads both (``torch.where``)
    moves."""
    n, w = row_mask.shape[0], field_mask.shape[0]
    merged = int(row_mask.sum())
    values = n * w * elem_size
    return {"mask_aware": 2 * values + n + w + (2 * n - merged) * ts_size,
            "both_operands": 3 * values + n + w + 2 * n * ts_size}


def _check(base, upd, row_mask, field_mask, ts_base, ts_new) -> None:
    for name, t in (("base", base), ("upd", upd), ("row_mask", row_mask),
                    ("field_mask", field_mask), ("ts_base", ts_base)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != base.device:
            raise ValueError(f"{name} is on {t.device}, base on "
                             f"{base.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if base.device.type not in ("cpu", "cuda"):
        raise ValueError(f"base is on {base.device}; only cpu and cuda")
    if base.ndim != 2 or upd.shape != base.shape or upd.dtype != base.dtype:
        raise ValueError(f"base and upd must be one (N, W) shape and dtype, "
                         f"got {tuple(base.shape)} {base.dtype} and "
                         f"{tuple(upd.shape)} {upd.dtype}")
    if base.element_size() not in (1, 2, 4, 8) or base.is_complex():
        raise TypeError(f"unsupported value dtype {base.dtype}")
    n, w = base.shape
    if row_mask.dtype != torch.bool or tuple(row_mask.shape) != (n,):
        raise ValueError(f"row_mask must be ({n},) bool, got "
                         f"{tuple(row_mask.shape)} {row_mask.dtype}")
    if field_mask.dtype != torch.bool or tuple(field_mask.shape) != (w,):
        raise ValueError(f"field_mask must be ({w},) bool, got "
                         f"{tuple(field_mask.shape)} {field_mask.dtype}")
    if ts_base.dtype not in _TS_DTYPES or tuple(ts_base.shape) != (n,):
        raise ValueError(f"ts_base must be ({n},) int32 or int64, got "
                         f"{tuple(ts_base.shape)} {ts_base.dtype}")
    info = torch.iinfo(ts_base.dtype)
    if not info.min <= int(ts_new) <= info.max:
        raise ValueError(f"ts_new {ts_new} does not fit {ts_base.dtype}")


def masked_merge(base: torch.Tensor, upd: torch.Tensor,
                 row_mask: torch.Tensor, field_mask: torch.Tensor,
                 ts_base: torch.Tensor, ts_new: int):
    """base/upd: (N, W) of one dtype; row_mask: (N,) bool; field_mask:
    (W,) bool; ts_base: (N,) int32 or int64; ts_new: int -> (merged (N, W),
    ts_out (N,) of ts_base's dtype), all on base's device.

    A CPU tensor takes the plain torch version; a CUDA tensor launches the
    kernel (and counts the launch in ``masked_merge.launches``)."""
    _check(base, upd, row_mask, field_mask, ts_base, ts_new)
    if base.device.type == "cpu":
        return ref.ref_masked_merge(base, upd, row_mask, field_mask, ts_base,
                                    int(ts_new))
    n, w = base.shape
    plan = merge_plan(base, upd)
    units = w * base.element_size() // plan.vec_bytes
    if plan.rows_per_block * units >= 2**31:
        raise ValueError(f"W = {w} is too wide for the kernel's 32-bit "
                         f"in-block index")
    out = torch.empty_like(base)
    ts_out = torch.empty_like(ts_base)
    if n == 0:
        return out, ts_out
    fn = _build.kernel_fn("masked_merge", "masked_merge_launch", _ARGS)
    with torch.cuda.device(base.device):
        rc = fn(base.data_ptr(), upd.data_ptr(), row_mask.data_ptr(),
                field_mask.data_ptr(), ts_base.data_ptr(), int(ts_new),
                out.data_ptr(), ts_out.data_ptr(), n, w, base.element_size(),
                ts_base.element_size(), plan.vec_bytes, plan.rows_per_block,
                plan.threads, stream_ptr(base))
    _build.check(rc, "masked_merge", "masked_merge_launch")
    count_launch(masked_merge)
    return out, ts_out


masked_merge.launches = 0
