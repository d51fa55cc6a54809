"""Blocked causal flash attention: the serving prefill's attention.

Materializing the (Sq, Sk) logits of a 32k-token prompt is not feasible
in device memory (137 GB for llama3.2-1b's 32 heads in f32), so the
prefill runs the flash algorithm: an online softmax over key tiles with
f32 running max, sum and accumulator, and no tile past the diagonal.

The kernel is ``csrc/flash_attention.cu``; its plain version is
``ref.ref_flash_attention``, which runs the same loop in torch ops on
(bq, bk) tiles. The layout is the JAX package's, (B, S, H, D) for q and
(B, S, K, D) for k and v, at the function: the kernel reads through the
strides, so nothing is transposed or padded first.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from ._compat import count_launch, stream_ptr

#: head dims the kernel is built for (the JAX package's kernel tests and
#: llama3.2-1b's 64)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
         + [ctypes.c_float, ctypes.c_void_p])


def _check(q, k, v, causal: bool) -> None:
    if not causal:
        raise NotImplementedError("only the causal serving path is "
                                  "kernelized")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share float32 or bfloat16, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q is on {q.device}; only cpu and cuda")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         f"kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D), H % K == 0, float32 or
    bfloat16, D in ``HEAD_DIMS`` -> (B, Sq, H, D) in q's dtype.

    Causal with the queries aligned to the END of the key axis (prefill
    and chunked prefill both satisfy this). A CPU tensor takes the plain
    torch version; a CUDA tensor launches the kernel (and counts the
    launch in ``flash_attention.launches``)."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, h, kh, d, _DTYPES[q.dtype], q.stride(0), q.stride(1),
                q.stride(2), k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2), d ** -0.5,
                stream_ptr(q))
    _build.check(rc, "flash_attention", "flash_attention_launch")
    count_launch(flash_attention)
    return out


flash_attention.launches = 0


def causal_pairs(sq: int, sk: int) -> int:
    """Query-key pairs a causal end-aligned attention visits: query i sees
    keys 0 .. i + sk - sq, none when that is negative. Four times this
    times B*H*D is its FLOP count."""
    lo = max(0, sq - sk)          # the first query that sees a key
    n = max(sq - lo, 0)
    return (lo + sk - sq + 1 + sk) * n // 2
