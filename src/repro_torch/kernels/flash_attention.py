"""Blocked causal flash attention: the serving prefill's attention.

Materializing the (Sq, Sk) logits of a 32k-token prompt is not feasible
in device memory (137 GB for llama3.2-1b's 32 heads in f32), so the
prefill runs the flash algorithm: an online softmax over key tiles with
f32 running max, sum and accumulator, and no tile past the diagonal.

The kernels are in ``csrc/flash_attention.cu``; their plain version is
``ref.ref_flash_attention``, which runs the same loop in torch ops on
(bq, bk) tiles. The layout is the JAX package's, (B, S, H, D) for q and
(B, S, K, D) for k and v, at the function: the kernels read through the
strides, so nothing is transposed or padded first.

Four designs, chosen by (dtype, D) alone (:func:`design`):

* ``"wgmma"``, bf16 at D 64 and 128: Hopper's tensor cores. One block of
  three warpgroups per (128-row query tile, head, batch); a producer
  thread feeds Q once and K/V tiles of 128 keys through a ring in shared
  memory by TMA, and two consumer warpgroups of 64 rows each run both
  products with ``wgmma``. Blocks are launched heaviest query tile first.
* ``"wgmma_f32"``, f32 at D 64 and 128: the same skeleton on the tensor
  cores at f32 precision, each product taken as three TF32 products of
  the operands' hi and lo parts. The producer warpgroup loads raw K/V
  tiles by TMA and splits them (V transposed, since TF32 ``wgmma`` reads
  only K-major operands); q is read through its strides. Tiles per D in
  ``F32_TILES``.
* ``"mma"``, bf16 at D 16 and 32 (the Meta-pipe encoder's 32-token
  sequences): warp-level ``mma.sync`` on the tensor cores. A warp owns a
  16-row query strip of one (head, batch), and a block packs several
  strips and heads (:func:`mma_plan`), so a 32-token sequence fills its
  block; q, k and v come into shared memory as bf16 in 16-byte
  ``cp.async`` copies.
* ``"mma_f32"``, f32 at D 16 and 32: the ``mma`` skeleton (the same
  packing, q, k and v as f32 in 16-byte ``cp.async`` copies) with both
  products on the tensor cores at f32 precision, each as three TF32
  ``mma.sync`` products of the operands' hi and lo parts, as
  ``"wgmma_f32"`` takes them.

The host side of the launches is computed here, so the CPU tests reach
it: :func:`plan`, a pure function of the tensors' shapes, strides, dtype
and base alignment, gives the design, the query tiles, the TMA tensor
maps (dims, byte strides, boxes) or the ``mma`` packing, and names the
operands the kernel cannot read as they lie; the C launcher only encodes
the maps and checks the plan. :func:`launch_order`, :func:`mma_units`
and :func:`trip_count` state the block order and the causal trip counts
that the kernels compute from ``blockIdx``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from . import _build, ref
from ._compat import cdiv, count_launch

#: head dims the kernels are built for (the JAX package's kernel tests and
#: llama3.2-1b's 64)
HEAD_DIMS = (16, 32, 64, 128)
#: head dims that take the wgmma kernels (in either dtype)
WGMMA_HEAD_DIMS = (64, 128)
#: the launcher's design codes are the indices
DESIGNS = ("wgmma", "mma_f32", "wgmma_f32", "mma")
#: the designs of 16-row strips packed a block (:func:`mma_plan`)
MMA_DESIGNS = ("mma", "mma_f32")
BLOCK_Q = 128    # query rows per block of the wgmma kernel (2 x 64)
BLOCK_K = 128    # keys per K/V tile of the wgmma kernel
#: the wgmma_f32 kernel's (query rows per block, keys per K/V tile) per D:
#: two 64-row consumers and 64-key tiles at D 64, one consumer and 32-key
#: tiles at D 128 (shared memory: 192 and 224 KB)
F32_TILES = {64: (128, 64), 128: (64, 32)}
SWIZZLE_BYTES = 128  # a TMA box row: the row of the 128-byte swizzle
BOX_COLS = 64    # head-dim columns per bf16 TMA box (32 per f32 box)
TMA_ALIGN = 16   # bytes: TMA's alignment of the base and of every stride
#: the mma designs: query rows a warp owns (one m16 strip), keys per K/V
#: tile, most warps a block
MMA_ROWS = 16
MMA_BK = 32
MMA_WARPS = 8
MMA_PAD = 16     # bytes past each shared-memory row (one cp.async piece)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, o, the plan's args, the scale, the stream
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]


def design(dtype: torch.dtype, d: int) -> str:
    """The kernel a (dtype, head dim) takes: ``"wgmma"`` for bf16 and
    ``"wgmma_f32"`` for f32 at D 64 and 128, ``"mma"`` for bf16 and
    ``"mma_f32"`` for f32 at D 16 and 32."""
    bf16 = dtype == torch.bfloat16
    if d not in WGMMA_HEAD_DIMS:
        return "mma" if bf16 else "mma_f32"
    return "wgmma" if bf16 else "wgmma_f32"


def block_shape(dtype: torch.dtype, d: int) -> tuple[int, int]:
    """(query rows per block, keys per K/V tile) of a tensor-core design:
    what :func:`trip_count` and :func:`launch_order` take as bq, bk."""
    if design(dtype, d) == "wgmma_f32":
        return F32_TILES[d]
    return BLOCK_Q, BLOCK_K


def trip_count(q_tile: int, sq: int, sk: int, bq: int = BLOCK_Q,
               bk: int = BLOCK_K) -> int:
    """Key tiles a block of query rows [q_tile * bq, q_tile * bq + bq)
    visits: those holding keys up to its last row's position, none when
    that row precedes every key (the plain version's causal trip count)."""
    q1 = min((q_tile + 1) * bq, sq)
    return min(max(cdiv(sk - sq + q1, bk), 0), cdiv(sk, bk))


def launch_order(sq: int, n_heads: int, batch: int,
                 bq: int = BLOCK_Q) -> list[tuple[int, int, int]]:
    """(query tile, head, batch) of each block, by ``blockIdx.x``: the
    last query tile (the most key tiles) first, over every head and batch,
    and the heads that share a KV head side by side. The kernel maps
    ``blockIdx.x`` the same way."""
    n_q = cdiv(sq, bq)
    per = n_heads * batch
    return [(n_q - 1 - t // per, (t % per) % n_heads, (t % per) // n_heads)
            for t in range(n_q * per)]


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """The ``mma`` designs' packing. A unit is one 16-row query strip of
    one (head, batch), owned by one warp; a block holds
    ``strips_per_block`` consecutive strips of ``heads_per_block``
    consecutive heads of one batch element (a divisor of the head count,
    so no block spans two batch elements and none has a missing head).
    Block ``x`` is (strip group ``strip_groups - 1 - x // (head_groups *
    B)``, head group ``x % (head_groups * B) % head_groups``, batch
    ``x % (head_groups * B) // head_groups``): the strip group with the
    most key tiles first. Warp ``w`` takes strip ``w % strips_per_block``
    and head ``w // strips_per_block`` of its block."""
    strips: int              # 16-row strips per head: cdiv(Sq, 16)
    strips_per_block: int
    heads_per_block: int
    kv_heads_per_block: int  # most KV heads one block's heads read
    stages: int              # K/V tiles in flight: 2 where a strip visits
                             # more than one, else 1
    strip_groups: int
    head_groups: int
    blocks: int
    smem: int                # dynamic shared memory of a block, bytes

    @property
    def warps(self) -> int:
        return self.strips_per_block * self.heads_per_block


def mma_plan(sq: int, sk: int, n_heads: int, n_kv_heads: int, batch: int,
             d: int, es: int = 2) -> MmaPlan:
    """The ``mma`` designs' packing (see :class:`MmaPlan`) at element size
    ``es`` (2: bf16, ``mma``; 4: f32, ``mma_f32``): as many strips of a
    head as fit in ``MMA_WARPS`` warps, then as many heads as the rest
    allows, the largest divisor of the head count that fits. At the
    Meta-pipe encoder's S 32 with 8 heads: 2 strips x 4 heads, 8 warps.
    Shared memory: the block's query rows, then ``stages`` K and V tiles
    per KV head, each row padded by ``MMA_PAD`` bytes and each head's
    region skewed by as many (no bank conflict for ``ldmatrix``)."""
    strips = cdiv(sq, MMA_ROWS)
    sb = max(min(strips, MMA_WARPS), 1)
    hb = max(x for x in range(1, n_heads + 1)
             if n_heads % x == 0 and x * sb <= MMA_WARPS)
    group = n_heads // n_kv_heads
    nkv = max((h0 + hb - 1) // group - h0 // group + 1
              for h0 in range(0, n_heads, hb))
    stages = 2 if trip_count(strips - 1, sq, sk, MMA_ROWS, MMA_BK) > 1 else 1
    n_sg, n_hg = cdiv(strips, sb), n_heads // hb
    pad = MMA_PAD // es
    rs = d + pad
    smem = es * (sb * hb * MMA_ROWS * rs + hb * pad
                 + stages * 2 * (nkv * MMA_BK * rs + nkv * pad))
    return MmaPlan(strips, sb, hb, nkv, stages, n_sg, n_hg,
                   n_sg * n_hg * batch, smem)


def mma_units(p: MmaPlan, batch: int) -> list[list[tuple | None]]:
    """(strip, head, batch) of each warp of each block, by ``blockIdx.x``
    and warp, or None for a warp past the last strip. The kernel maps
    ``blockIdx.x`` and its warps the same way."""
    per = p.head_groups * batch
    out = []
    for x in range(p.blocks):
        sg = p.strip_groups - 1 - x // per
        hg, b = x % per % p.head_groups, x % per // p.head_groups
        warps = []
        for w in range(p.warps):
            strip = sg * p.strips_per_block + w % p.strips_per_block
            head = hg * p.heads_per_block + w // p.strips_per_block
            warps.append((strip, head, b) if strip < p.strips else None)
        out.append(warps)
    return out


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """One TMA tensor map over a (B, S, heads, D) bf16 or f32 tensor, as
    ``cuTensorMapEncodeTiled`` takes it: dims innermost first (D, heads,
    S, B), the byte strides of dims 1-3, and the box one load copies (one
    128-byte swizzle row of columns, 64 bf16 or 32 f32, of one head over
    a tile's rows)."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]

    def packed(self) -> list[int]:
        return [*self.dims, *self.strides, *self.box]


def tensor_map(t: torch.Tensor, rows: int = BLOCK_Q) -> TensorMap | None:
    """The TMA map of ``t`` (B, S, heads, D), or None when TMA cannot read
    it as it lies: a base or a stride that is not a multiple of
    ``TMA_ALIGN`` bytes. A dim of size 1 is never stepped over, so its
    stride is taken as the contiguous one."""
    return _tensor_map(tuple(t.shape), t.stride(), t.element_size(),
                       t.data_ptr() % TMA_ALIGN == 0, rows)


def _strides(shape, stride, es, aligned) -> list[int] | None:
    """The byte strides of dims (heads, S, B) of a (B, S, heads, D)
    tensor, or None where the base or a stride is not a multiple of
    ``TMA_ALIGN`` bytes. A dim of size 1 is never stepped over, so its
    stride is taken as the contiguous one."""
    b, s, h, d = shape
    strides, inner = [], d * es
    for size, st in zip((h, s, b), (stride[2], stride[1], stride[0])):
        strides.append(st * es if size > 1 else inner)
        inner *= max(size, 1)
    if not aligned or any(st % TMA_ALIGN for st in strides):
        return None
    return strides


def _tensor_map(shape, stride, es, aligned, rows) -> TensorMap | None:
    strides = _strides(shape, stride, es, aligned)
    if strides is None:
        return None
    b, s, h, d = shape
    # an empty key axis is never loaded (no key tile), but the map needs
    # a positive extent to encode
    return TensorMap((d, h, max(s, 1), b), tuple(strides),
                     (SWIZZLE_BYTES // es, 1, rows, 1))


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """What the host hands the C launcher for one call."""
    design: str
    n_q_tiles: int               # wgmma designs: query tiles per (head,
                                 # batch); mma designs: strip groups
    maps: tuple | None           # TensorMap of q, k, v (wgmma_f32 reads
                                 # q through its strides: None)
    copies: tuple[str, ...]      # operands the kernel cannot read as they
                                 # lie
    # the launcher's long long[51]: batch, sq, sk, heads, kv heads, D,
    # dtype, design, n_q_tiles (mma: its block count), the (batch, seq,
    # head) element strides of q, k and v, then the three maps (zeros
    # where there is none); the mma designs append their strips, heads and
    # KV heads a block, stages and shared-memory bytes (56 values); None
    # while an operand needs a copy
    args: object = dataclasses.field(default=None, compare=False)
    mma: MmaPlan | None = None


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> FlashPlan:
    """The launch plan of checked q, k, v. ``copies`` names each operand
    whose base or strides the kernel cannot read (TMA's, or the ``mma``
    designs' 16-byte copies: base and strides a multiple of 16 bytes); the
    wrapper copies those (``torch.contiguous_format``)
    and plans again. Nothing here touches the data. Plans are cached by
    shapes, strides and base alignment: a prefill calls with the same
    layout in every layer, and the first bucket's call is launch-bound."""
    return _plan(q.dtype, *((tuple(t.shape), t.stride(),
                             t.data_ptr() % TMA_ALIGN == 0)
                            for t in (q, k, v)))


@functools.lru_cache(maxsize=1024)
def _plan(dtype, *operands) -> FlashPlan:
    (b, sq, h, d), (_, sk, kh, _) = operands[0][0], operands[1][0]
    kind = design(dtype, d)
    head = [b, sq, sk, h, kh, d, _DTYPES[dtype], DESIGNS.index(kind)]
    strides = [st for _, stride, _ in operands for st in stride[:3]]
    es = torch.empty((), dtype=dtype).element_size()
    if kind in MMA_DESIGNS:
        copies = tuple(n for n, (shape, stride, aligned)
                       in zip("qkv", operands)
                       if _strides(shape, stride, es, aligned) is None)
        mp = mma_plan(sq, sk, h, kh, b, d, es)
        if copies:
            return FlashPlan(kind, mp.strip_groups, None, copies, mma=mp)
        return FlashPlan(kind, mp.strip_groups, None, (), _longs(
            head + [mp.blocks] + strides + [0] * 33
            + [mp.strips_per_block, mp.heads_per_block,
               mp.kv_heads_per_block, mp.stages, mp.smem]), mp)
    bq, bk = block_shape(dtype, d)
    mapped = "kv" if kind == "wgmma_f32" else "qkv"
    maps = tuple(_tensor_map(shape, stride, es, aligned,
                             bq if n == "q" else bk) if n in mapped else None
                 for n, (shape, stride, aligned) in zip("qkv", operands))
    copies = tuple(n for n, m in zip("qkv", maps) if n in mapped and m is None)
    n_q = cdiv(sq, bq)
    if copies:
        return FlashPlan(kind, n_q, None, copies)
    return FlashPlan(kind, n_q, maps, (), _longs(
        head + [n_q] + strides
        + [x for m in maps for x in (m.packed() if m else [0] * 11)]))


def _longs(vals):
    return (ctypes.c_longlong * len(vals))(*vals)


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


def tma_ready(q, k, v):
    """(q, k, v, plan) with each operand the kernel cannot read as it
    lies (TMA's, or the ``mma`` designs' 16-byte copies) copied into a
    fresh contiguous tensor, and the plan of what is launched."""
    p = plan(q, k, v)
    if p.copies:
        q, k, v = (t.clone(memory_format=torch.contiguous_format)
                   if n in p.copies else t for n, t in zip("qkv", (q, k, v)))
        p = plan(q, k, v)
    return q, k, v, p


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D), H % K == 0, float32 or
    bfloat16, D in ``HEAD_DIMS`` -> (B, Sq, H, D) in q's dtype.

    Causal with the queries aligned to the END of the key axis (prefill
    and chunked prefill both satisfy this). A CPU tensor takes the plain
    torch version; a CUDA tensor launches the kernel of its
    :func:`design` (and counts the launch in ``flash_attention.launches``
    and ``flash_attention.by_design``)."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v, p = tma_ready(q, k, v)
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch", _ARGS)
    # the first bucket's call is launch-bound: switch devices only when q
    # is not on the current one
    here = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                p.args, q.shape[3] ** -0.5,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention", "flash_attention_launch")
    count_launch(flash_attention, p.design)
    return out


flash_attention.launches = 0
flash_attention.by_design = dict.fromkeys(DESIGNS, 0)


def causal_pairs(sq: int, sk: int) -> int:
    """Query-key pairs a causal end-aligned attention visits: query i sees
    keys 0 .. i + sk - sq, none when that is negative. Four times this
    times B*H*D is its FLOP count."""
    lo = max(0, sq - sk)          # the first query that sees a key
    n = max(sq - lo, 0)
    return (lo + sk - sq + 1 + sk) * n // 2
