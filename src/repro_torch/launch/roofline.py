"""Roofline terms of one kernel launch on the port's card.

Constants: NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates at the
700 W power limit). A card set below 700 W reaches less; readers compare
against ``nvidia-smi``'s ``power.limit``.
"""
from __future__ import annotations

HBM_BW = 3.35e12             # bytes/s, HBM3
PEAK_CUDA_CORE_OPS = 67e12   # float32 FLOP/s outside the tensor cores; the
                             # data sheet gives no int32 rate, so integer and
                             # compare work is bounded by this one
PEAK_TENSOR_BF16 = 989.4e12  # dense bf16 FLOP/s of the tensor cores (the
                             # data sheet's 1,979 TFLOP/s is with sparsity)
PEAK_TENSOR_TF32 = 494.7e12  # dense TF32 FLOP/s of the tensor cores (the
                             # data sheet's 989 TFLOP/s is with sparsity)
#: TF32 products per f32-accurate product: each operand split into a TF32
#: hi part and a TF32 lo part, a_lo b_hi + a_hi b_lo + a_hi b_hi
F32_SPLIT_PRODUCTS = 3


def compute_peak(dtype: str) -> float:
    """The least-time compute rate for matrix-product work in ``dtype``.
    "bfloat16": the tensor cores. "float32": the faster of the CUDA cores
    and the tensor cores at f32 precision, which take an f32 product as
    three TF32 products of split operands (494.7 / 3 = 164.9 TFLOP/s, the
    faster). Anything else: the CUDA cores."""
    if dtype == "bfloat16":
        return PEAK_TENSOR_BF16
    if dtype == "float32":
        return max(PEAK_CUDA_CORE_OPS, PEAK_TENSOR_TF32 / F32_SPLIT_PRODUCTS)
    return PEAK_CUDA_CORE_OPS


def kernel_roofline(flops: float, nbytes: float, wall_s: float) -> dict:
    """Single-kernel roofline terms from host-side launch accounting.

    ``flops``/``nbytes`` are the launch path's analytic estimates (see the
    call sites of ``obs/kerneltel.py``: ``batched_select``,
    ``compact_rewrite``, ``delta_codec`` and ``shard_route``), ``wall_s``
    the measured launch-to-host-sync wall. These kernels do integer and
    compare work on the CUDA cores, so their compute term uses the CUDA
    cores' rate (``compute_peak`` gives matrix-product work its rate).
    ``roofline_fraction`` is ``max(t_compute, t_memory) / wall``.
    """
    t_compute = flops / PEAK_CUDA_CORE_OPS
    t_memory = nbytes / HBM_BW
    t_min = max(t_compute, t_memory)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "dominant": "compute" if t_compute >= t_memory else "memory",
        "roofline_fraction": (t_min / wall_s) if wall_s > 0 else 0.0,
    }
