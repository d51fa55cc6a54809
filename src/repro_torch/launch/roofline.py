"""Roofline terms on the port's card: of one kernel launch
(:func:`kernel_roofline`), and of one sharded step (:class:`Roofline`,
the dry run's, ``launch/dryrun.py``).

Per (arch x shape x mesh):
  compute   = FLOPs_per_device / peak bf16 FLOP/s          [s]
  memory    = bytes_per_device / HBM rate                  [s]
  collective= collective_bytes_per_device / link rate      [s]

Collective bytes come from the step's collective records (op, bytes,
group size; :func:`collective_recorder`) with the JAX package's
ring-algorithm traffic factors (all-reduce 2(n-1)/n, all-gather and
all-to-all (n-1)/n on the gathered size, reduce-scatter (n-1) on the
scattered size, permute 1x).

Constants: NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates at the
700 W power limit). A card set below 700 W reaches less; readers compare
against ``nvidia-smi``'s ``power.limit``.
"""
from __future__ import annotations

import dataclasses

HBM_BW = 3.35e12             # bytes/s, HBM3
PEAK_CUDA_CORE_OPS = 67e12   # float32 FLOP/s outside the tensor cores; the
                             # data sheet gives no int32 rate, so integer and
                             # compare work is bounded by this one
PEAK_TENSOR_BF16 = 989.4e12  # dense bf16 FLOP/s of the tensor cores (the
                             # data sheet's 1,979 TFLOP/s is with sparsity)
PEAK_TENSOR_TF32 = 494.7e12  # dense TF32 FLOP/s of the tensor cores (the
                             # data sheet's 989 TFLOP/s is with sparsity)
LINK_BW = 450e9              # bytes/s each way of one H100 SXM's NVLink 4
                             # (the data sheet's 900 GB/s is both ways)
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


# ---------------------------------------------------------------------------
# a sharded step's roofline
# ---------------------------------------------------------------------------

#: the record names of the collectives, as the JAX package's HLO names them
_COLL_OPS = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}


def collective_bytes(records) -> dict:
    """Per-device traffic bytes by collective kind (ring factors applied)
    of collective ``records``: ``{"op": "all-reduce" | "all-gather" |
    "reduce-scatter" | "all-to-all" | "collective-permute", "bytes": the
    result's bytes (the gathered size of an all-gather, the scattered
    size of a reduce-scatter), "group": ranks in the group}``."""
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "n_ops": 0}
    for r in records:
        op, nbytes, n = r["op"], r["bytes"], max(int(r["group"]), 2)
        if op == "all-reduce":
            traffic = 2.0 * nbytes * (n - 1) / n
        elif op == "all-gather":
            traffic = nbytes * (n - 1) / n          # nbytes = gathered size
        elif op == "reduce-scatter":
            traffic = nbytes * (n - 1)              # nbytes = scattered size
        elif op == "all-to-all":
            traffic = nbytes * (n - 1) / n
        else:
            traffic = float(nbytes)
        out[op] += traffic
        out["n_ops"] += 1
    return out


def collective_recorder():
    """A ``CommDebugMode`` that also keeps a record (:func:`collective_bytes`'s
    form) of each functional collective that runs under it, in
    ``.records``: the op, its result's bytes and its group's size."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    def group_size(args) -> int:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()

    class _Recorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: list[dict] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(getattr(func, "_overloadpacket", None),
                           "__name__", "")
            if (out is not NotImplemented and name in _COLL_OPS
                    and isinstance(out, torch.Tensor)):
                self.records.append({
                    "op": _COLL_OPS[name],
                    "bytes": out.numel() * out.element_size(),
                    "group": group_size(args)})
            return out

    return _Recorder()


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective: dict
    model_flops_global: float
    n_devices: int

    @property
    def collective_bytes_total(self) -> float:
        return sum(v for k, v in self.collective.items() if k != "n_ops")

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_TENSOR_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_total / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat/redundancy waste)."""
        counted = self.flops_per_device * self.n_devices
        return self.model_flops_global / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization if the dominant term were saturated:
        (model flops time) / max(term)."""
        t_model = self.model_flops_global / (self.n_devices
                                             * PEAK_TENSOR_BF16)
        t_max = max(self.t_compute, self.t_memory, self.t_collective)
        return t_model / t_max if t_max else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes_total,
            "collective_detail": self.collective,
            "model_flops_global": self.model_flops_global,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for a
    forward-only step (+ attention term for long contexts)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    base = mult * n * tokens
    # attention FLOPs (QK^T + PV), significant at 32k
    if not cfg.rwkv:
        attn_layers = sum(1 for l in range(cfg.n_layers)
                          if cfg.is_attn_layer(l))
        s = shape.seq_len
        if shape.mode == "decode":
            att = 2 * 2 * cfg.n_heads * cfg.hd * s  # one query over s keys
        else:
            att = 2 * 2 * cfg.n_heads * cfg.hd * s * (s + 1) / 2  # causal
        fb = 3.0 if shape.mode == "train" else 1.0
        base += fb * attn_layers * shape.global_batch * att
    return base
