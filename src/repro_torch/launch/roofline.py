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


def compute_peak(dtype: str) -> float:
    """The least-time compute rate for matrix-product work in ``dtype``
    ("bfloat16" -> the tensor cores; anything else -> the CUDA cores, since
    an f32 product at f32 precision does not run on the tensor cores)."""
    return PEAK_TENSOR_BF16 if dtype == "bfloat16" else PEAK_CUDA_CORE_OPS


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
