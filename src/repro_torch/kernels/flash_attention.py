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

* ``"wgmma"``, bf16 at D 64, 112 and 128: Hopper's tensor cores (D 112
  in D 128's tiles, TMA filling the columns past 112 with zeros). One
  block of three warpgroups per (128-row query tile, head, batch); a producer
  thread feeds Q once and K/V tiles of 128 keys through a ring in shared
  memory by TMA, and two consumer warpgroups of 64 rows each run both
  products with ``wgmma``. Blocks are launched heaviest query tile first.
* ``"wgmma_f32"``, f32 at D 64, 112 and 128: the same skeleton on the
  tensor cores at f32 precision, each product taken as three TF32 products of
  the operands' hi and lo parts. The producer warpgroup loads raw K/V
  tiles by TMA and splits them (V transposed, since TF32 ``wgmma`` reads
  only K-major operands); q is read through its strides. Tiles per D in
  ``F32_TILES``.
* ``"mma"``, bf16 at D 8, 16 and 32 (the Meta-pipe encoder's 32-token
  sequences): warp-level ``mma.sync`` on the tensor cores. A warp owns a
  16-row query strip of one (head, batch), and a block packs several
  strips and heads (:func:`mma_plan`), so a 32-token sequence fills its
  block; q, k and v come into shared memory as bf16 in 16-byte
  ``cp.async`` copies.
* ``"mma_f32"``, f32 at D 8, 16 and 32: the ``mma`` skeleton (the same
  packing, q, k and v as f32 in 16-byte ``cp.async`` copies) with both
  products on the tensor cores at f32 precision, each as three TF32
  ``mma.sync`` products of the operands' hi and lo parts, as
  ``"wgmma_f32"`` takes them.

Training goes through :class:`FlashAttentionFn` (what
:func:`flash_attention` takes when an input requires grad): its forward
launches the design of its (dtype, D) with an lse buffer, so the kernel
also writes each row's log-sum-exp, and its backward launches the three
kernels of ``csrc/flash_attention_bwd.cu`` (:func:`flash_bwd_delta`,
:func:`flash_bwd_dkdv`, :func:`flash_bwd_dq`, planned by
:func:`bwd_plan`), which recompute P from q, k and the lse, at every head
dim of ``HEAD_DIMS``, on the tensor cores. At D 64, 112 and 128 the dkdv
and dq kernels are ``wgmma`` fed by TMA (D 112 in D 128's tiles): in bf16
P and dS enter the products as two bf16 parts, in f32 (``wgmma_f32``)
every product is three TF32 products of split operands, the transposed B
operands written by a producer warpgroup. At D 8, 16 and 32 they are
``mma.sync`` kernels with the forward's packing (:func:`mma_bwd_plan`:
16-key strips of several KV heads a block for dkdv, 16-row query strips
as the forward's for dq), with the same arithmetic per dtype. The JAX
package differentiates its XLA scan under ``jax.checkpoint``, which
recomputes the forward in the backward; the port saves o and the lse
instead, and the arithmetic is the same: f32 logits, P and dS, f32 sums.

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

#: head dims the kernels are built for: 16 to 128 (the JAX package's
#: kernel tests; llama3.2-1b's 64), kimi-k2's 112 and qwen2-0.5b's smoke
#: config's 8
HEAD_DIMS = (8, 16, 32, 64, 112, 128)
#: head dims that take the wgmma kernels (in either dtype); D 112 runs in
#: D 128's tiles, its columns past 112 zero-filled by TMA
WGMMA_HEAD_DIMS = (64, 112, 128)
#: the launcher's design codes are the indices
DESIGNS = ("wgmma", "mma_f32", "wgmma_f32", "mma")
#: the designs of 16-row strips packed a block (:func:`mma_plan`)
MMA_DESIGNS = ("mma", "mma_f32")
BLOCK_Q = 128    # query rows per block of the wgmma kernel (2 x 64)
BLOCK_K = 128    # keys per K/V tile of the wgmma kernel
#: the wgmma_f32 kernel's (query rows per block, keys per K/V tile) per D:
#: two 64-row consumers and 64-key tiles at D 64, one consumer and 32-key
#: tiles at D 128 and 112 (shared memory: 192 and 224 KB)
F32_TILES = {64: (128, 64), 112: (64, 32), 128: (64, 32)}
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
# q, k, v, o, lse (or null), the plan's args, the scale, the stream
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_void_p]
#: head dims the backward kernels are built for: every forward head dim
BWD_HEAD_DIMS = HEAD_DIMS
#: the backward's designs by launcher code, all on the tensor cores, the
#: forward's names: at D 64, 112 and 128 f32 (three TF32 products of split
#: operands) and bf16 by wgmma, at D 8, 16 and 32 the same by mma.sync
BWD_DESIGNS = ("wgmma_f32", "wgmma", "mma_f32", "mma")
BWD_THREADS = 256  # the delta kernel's block
BWD_VEC = 4      # the delta kernel's elements a load: bases and strides a
                 # multiple of it
#: the bf16 backward's tiles per D: dkdv's (query rows a tile, keys a
#: block: 64 per consumer warpgroup, two at D 64 and one at D 128), and
#: dq's (query rows a block: two 64-row consumers, keys a tile)
BWD_WGMMA_TILES = {64: ((64, 128), (128, 64)), 112: ((64, 64), (128, 64)),
                   128: ((64, 64), (128, 64))}
#: the f32 backward's tiles per D: dkdv's (query rows a trip, keys a block:
#: 64, the dV and dK warpgroups both on them), and dq's (query rows a
#: block: one 64-row consumer, keys a trip); what shared memory holds with
#: every operand as a TF32 hi and lo part (csrc/flash_attention_bwd.cu);
#: D 112 in D 128's tiles, as in bf16
BWD_WGMMA_F32_TILES = {64: ((32, 64), (64, 32)), 112: ((16, 64), (64, 16)),
                       128: ((16, 64), (64, 16))}
#: the names of the backward's TMA operands, in the launcher's map order
BWD_OPERANDS = ("q", "k", "v", "do")


def design(dtype: torch.dtype, d: int) -> str:
    """The kernel a (dtype, head dim) takes: ``"wgmma"`` for bf16 and
    ``"wgmma_f32"`` for f32 at D 64, 112 and 128, ``"mma"`` for bf16 and
    ``"mma_f32"`` for f32 at D 8, 16 and 32."""
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
    sb, hb = _mma_pack(strips, n_heads)
    group = n_heads // n_kv_heads
    nkv = max((h0 + hb - 1) // group - h0 // group + 1
              for h0 in range(0, n_heads, hb))
    stages = 2 if trip_count(strips - 1, sq, sk, MMA_ROWS, MMA_BK) > 1 else 1
    n_sg, n_hg = cdiv(strips, sb), n_heads // hb
    pad = MMA_PAD // es
    smem = es * (_mma_rows(sb, hb, d, es)
                 + stages * 2 * nkv * (MMA_BK * (d + pad) + pad))
    return MmaPlan(strips, sb, hb, nkv, stages, n_sg, n_hg,
                   n_sg * n_hg * batch, smem)


def _mma_pack(strips: int, n_heads: int) -> tuple[int, int]:
    """(strips, heads) a block: as many strips as fit in ``MMA_WARPS``
    warps, then the largest divisor of the head count that the rest
    allows."""
    sb = max(min(strips, MMA_WARPS), 1)
    hb = max(x for x in range(1, n_heads + 1)
             if n_heads % x == 0 and x * sb <= MMA_WARPS)
    return sb, hb


def _mma_rows(sb: int, hb: int, d: int, es: int) -> int:
    """Elements of a block's strip rows (one region of q, dO, K or V):
    ``sb * hb`` warps of 16 rows of ``d + MMA_PAD // es``, each head's
    rows skewed by one piece."""
    pad = MMA_PAD // es
    return sb * hb * MMA_ROWS * (d + pad) + hb * pad


def mma_bwd_plan(sq: int, sk: int, n_heads: int, n_kv_heads: int,
                 batch: int, d: int, es: int = 2) -> tuple[MmaPlan, MmaPlan]:
    """The ``mma`` backward's packing, (dkdv, dq), at element size ``es``.

    dkdv: a unit is one 16-key strip of one (KV head, batch), owned by a
    warp; a block holds ``strips_per_block`` strips of ``heads_per_block``
    KV heads (:func:`_mma_pack` over the key strips and the KV heads), and
    each trip brings one query head of each of its KV heads
    (``kv_heads_per_block`` = ``heads_per_block``): for each of the G
    query heads and each 32-row query tile from the first that sees one of
    the block's keys. Block ``x`` is (strip group ``x // (head_groups *
    B)``, KV head group ``x % (head_groups * B) % head_groups``, batch
    ``x % (head_groups * B) // head_groups``): strip group 0, the most
    query tiles, first (:func:`mma_bwd_units`). Two stages where G times
    the query tiles exceeds one. Shared memory: the K and V strip rows,
    per stage the q and dO tiles of the trip's heads, then per stage their
    lse and delta rows (f32).

    dq: the forward's packing (:func:`mma_plan`), a warp a 16-row query
    strip of one (head, batch), with dO's rows beside q's in shared
    memory."""
    strips = cdiv(sk, MMA_ROWS)
    sb, hb = _mma_pack(strips, n_kv_heads)
    group = n_heads // n_kv_heads
    stages = 2 if group * cdiv(sq, MMA_BK) > 1 else 1
    n_sg, n_hg = cdiv(strips, sb), n_kv_heads // hb
    pad = MMA_PAD // es
    tile = MMA_BK * (d + pad) + pad
    smem = (es * (2 * _mma_rows(sb, hb, d, es) + stages * 2 * hb * tile)
            + stages * 2 * hb * MMA_BK * 4)
    dkdv = MmaPlan(strips, sb, hb, hb, stages, n_sg, n_hg,
                   n_sg * n_hg * batch, smem)
    fwd = mma_plan(sq, sk, n_heads, n_kv_heads, batch, d, es)
    dq = dataclasses.replace(fwd, smem=fwd.smem + es * _mma_rows(
        fwd.strips_per_block, fwd.heads_per_block, d, es))
    return dkdv, dq


def mma_bwd_units(p: MmaPlan, batch: int) -> list[list[tuple | None]]:
    """(key strip, KV head, batch) of each warp of each block of the
    ``mma`` dkdv kernel, by ``blockIdx.x`` and warp (``p`` its plan from
    :func:`mma_bwd_plan`), or None for a warp past the last strip: strip
    group 0 first."""
    per = p.head_groups * batch
    out = []
    for x in range(p.blocks):
        sg, hg, b = x // per, x % per % p.head_groups, x % per // p.head_groups
        warps = []
        for w in range(p.warps):
            strip = sg * p.strips_per_block + w % p.strips_per_block
            head = hg * p.heads_per_block + w // p.strips_per_block
            warps.append((strip, head, b) if strip < p.strips else None)
        out.append(warps)
    return out


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
    if _is_fake(q):
        return ShapeOnlyFlashFn.apply(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v)
    return _forward(q, k, v, lse=False)[0]


def _forward(q, k, v, *, lse: bool):
    """(o, lse or None) of checked q, k, v: the plain version on the CPU,
    else one launch of the kernel of the tensors' design, which also
    writes the (B, H, Sq) f32 log-sum-exp where ``lse`` (every design)."""
    if q.device.type == "cpu":
        if lse:
            return ref.ref_flash_attention(q, k, v, return_lse=True)
        return ref.ref_flash_attention(q, k, v), None
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                         dtype=torch.float32, device=q.device)
             if lse else None)
    if out.numel() == 0:
        return out, lse_t
    q, k, v, p = tma_ready(q, k, v)
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch", _ARGS)
    # the first bucket's call is launch-bound: switch devices only when q
    # is not on the current one
    here = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if lse_t is None else lse_t.data_ptr(), p.args,
                q.shape[3] ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention", "flash_attention_launch")
    count_launch(flash_attention, p.design)
    return out, lse_t


flash_attention.launches = 0
flash_attention.by_design = dict.fromkeys(DESIGNS, 0)


def causal_pairs(sq: int, sk: int) -> int:
    """Query-key pairs a causal end-aligned attention visits: query i sees
    keys 0 .. i + sk - sq, none when that is negative. Four times this
    times B*H*D is its FLOP count."""
    lo = max(0, sq - sk)          # the first query that sees a key
    n = max(sq - lo, 0)
    return (lo + sk - sq + 1 + sk) * n // 2


# ---------------------------------------------------------------------------
# the backward (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernels' launch geometry, by ``design`` (the forward's
    design of the (dtype, D)): at D 64, 112 and 128 ``"wgmma"`` (bf16,
    tiles ``BWD_WGMMA_TILES``) or ``"wgmma_f32"`` (f32, tiles
    ``BWD_WGMMA_F32_TILES``); at D 8, 16 and 32 ``"mma"`` or ``"mma_f32"``,
    packed by :func:`mma_bwd_plan` (``mma``: its dkdv and dq plans), with
    ``bq`` 32-row query tiles, ``bk`` 16-key strips, ``dq_bq`` 16-row
    query strips and ``dq_bk`` 32-key tiles. All on the tensor cores.

    * dkdv: ``dkdv_blocks`` = key tiles of ``bk`` keys x KV heads x B;
      block ``x`` is (key tile ``x // (K B)``, KV head ``x % (K B) % K``,
      batch ``x % (K B) // K``), key tile 0 (the most query tiles) first.
      Key tile ``t`` visits the query tiles of ``bq`` rows
      ``first_q_tile[t]`` .. ``n_q_tiles - 1`` for each of the G query
      heads of its KV head (``bk``: 64 keys per consumer warpgroup in
      bf16, 128 at D 64 and 64 at D 128; 64 in f32).
    * dq: ``dq_blocks`` = query tiles of ``dq_bq`` rows x H x B, in the
      forward's order (:func:`launch_order` at ``dq_bq``); query tile
      ``t`` visits key tiles of ``dq_bk`` keys 0 .. ``dq_trips[t] - 1``.
    * delta: :func:`delta_lanes` threads a row, ``delta_blocks``.

    ``copies`` names the operands of q, k, v and dO (``BWD_OPERANDS``)
    that the kernels cannot read as they lie: a base or stride that is not
    a multiple of ``TMA_ALIGN`` bytes or a head dim that is not contiguous
    (both designs), a zero stride (the dO of a scalar loss; TMA only). The
    wrappers copy those and plan again. ``maps`` (wgmma designs, once
    nothing needs a copy): the TMA maps of q, k, v and dO with dkdv's
    boxes, then with dq's (32-column boxes in f32, 64 in bf16: one
    128-byte swizzle row)."""
    n_q_tiles: int
    n_k_tiles: int
    dkdv_blocks: int
    dq_blocks: int
    delta_blocks: int
    first_q_tile: tuple[int, ...]
    dq_trips: tuple[int, ...]
    copies: tuple[str, ...]
    bq: int
    bk: int
    design: str
    dq_q_tiles: int
    dq_bq: int
    dq_bk: int
    maps: tuple | None
    mma: tuple[MmaPlan, MmaPlan] | None = None


def delta_lanes(d: int) -> int:
    """The delta kernel's threads a row: the largest power of two at most
    D / 4 and 32, so that a row's lanes are an aligned group inside a warp
    (D 112: 16 lanes over its 28 four-element pieces)."""
    n = 1
    while 2 * n <= min(d // 4, 32):
        n *= 2
    return n


def _vec_ok(t: torch.Tensor) -> bool:
    """True where the delta kernel reads ``t`` as it lies: a contiguous
    head dim, and base and (batch, seq, head) strides a multiple of
    ``BWD_VEC`` elements (a dim of size 1 is never stepped over)."""
    return (t.stride(-1) == 1
            and t.data_ptr() % (BWD_VEC * t.element_size()) == 0
            and all(st % BWD_VEC == 0
                    for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))


def _bwd_map(shape, stride, es, aligned, rows) -> TensorMap | None:
    """The TMA map of a (B, S, heads, D) backward operand with boxes of
    ``rows`` rows, or None where TMA cannot read it as it lies: what
    :func:`tensor_map` refuses, a head dim that is not contiguous, or a
    zero stride over a dim of size > 1 (an expanded tensor)."""
    if stride[3] != 1 or any(st == 0 for n, st in zip(shape[:3], stride[:3])
                             if n > 1):
        return None
    return _tensor_map(shape, stride, es, aligned, rows)


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor | None = None) -> BwdPlan:
    """The backward's plan of (B, Sq, H, D) q and dO and (B, Sk, K, D) k,
    v: a pure function of their shapes, strides, dtype and base alignment
    (see :class:`BwdPlan`). Without ``do``, dO is taken as a contiguous,
    aligned tensor of q's shape."""
    ops = [(tuple(t.shape), t.stride(), t.data_ptr()) for t in (q, k, v)]
    if do is None:
        b, sq, h, d = q.shape
        ops.append((tuple(q.shape), (sq * h * d, h * d, d, 1), 0))
    else:
        ops.append((tuple(do.shape), do.stride(), do.data_ptr()))
    return _bwd_plan(q.dtype, *((shape, stride, ptr % TMA_ALIGN == 0)
                                for shape, stride, ptr in ops))


@functools.lru_cache(maxsize=1024)
def _bwd_plan(dtype, *operands) -> BwdPlan:
    (b, sq, h, d), (_, sk, kh, _) = operands[0][0], operands[1][0]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash backward kernels are built for D "
                         f"{BWD_HEAD_DIMS}, not {d}")
    kind = design(dtype, d)
    es = torch.empty((), dtype=dtype).element_size()
    mma = None
    if kind in MMA_DESIGNS:
        (bq, bk), (dq_bq, dq_bk) = (MMA_BK, MMA_ROWS), (MMA_ROWS, MMA_BK)
        mma = mma_bwd_plan(sq, sk, h, kh, b, d, es)
        maps = None
        copies = tuple(n for n, (shape, stride, aligned)
                       in zip(BWD_OPERANDS, operands)
                       if stride[3] != 1
                       or _strides(shape, stride, es, aligned) is None)
    else:
        (bq, bk), (dq_bq, dq_bk) = (BWD_WGMMA_TILES if kind == "wgmma"
                                    else BWD_WGMMA_F32_TILES)[d]
        boxes = [(bq, bk, bk, bq), (dq_bq, dq_bk, dq_bk, dq_bq)]
        maps = tuple(_bwd_map(shape, stride, es, aligned, rows)
                     for box in boxes
                     for (shape, stride, aligned), rows in zip(operands, box))
        copies = tuple(n for n, m in zip(BWD_OPERANDS, maps) if m is None)
        if copies:
            maps = None
    n_q, n_k, n_dq = cdiv(sq, bq), cdiv(sk, bk), cdiv(sq, dq_bq)
    offset = sk - sq
    first = tuple(max(t * bk - offset, 0) // bq for t in range(n_k))
    trips = tuple(trip_count(t, sq, sk, dq_bq, dq_bk) for t in range(n_dq))
    blocks = ((mma[0].blocks, mma[1].blocks) if mma
              else (n_k * kh * b, n_dq * h * b))
    return BwdPlan(n_q, n_k, *blocks,
                   cdiv(b * h * sq, BWD_THREADS // delta_lanes(d)), first,
                   trips, copies, bq, bk, kind, n_dq, dq_bq, dq_bk, maps,
                   mma)


def _bwd_check(q, k, v, like_q=(), rows=()) -> None:
    """Raise on inputs the backward kernels do not take: q, k, v as the
    forward takes them (D in ``HEAD_DIMS``, all of which the backward is
    built for); each of ``like_q`` (o, dO) q's shape, dtype and device;
    each of ``rows`` (lse, delta) a contiguous (B, H, Sq) f32 tensor on
    q's device."""
    _check(q, k, v, True)
    for t in like_q:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"o and dO must be {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    b, sq, h, _ = q.shape
    for t in rows:
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"lse and delta must be contiguous ({b}, {h}, "
                             f"{sq}) float32 on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _vec_ready(*ts):
    """Each tensor as it lies where the delta kernel reads it so, else
    a fresh contiguous copy (``contiguous()`` would hand back a contiguous
    view at a misaligned base as it is)."""
    return [t if _vec_ok(t) else t.clone(memory_format=torch.contiguous_format)
            for t in ts]


def bwd_ready(q, k, v, do):
    """(q, k, v, dO, plan) with each operand the plan names in ``copies``
    copied into a fresh contiguous tensor, and the plan of what is
    launched."""
    p = bwd_plan(q, k, v, do)
    if p.copies:
        q, k, v, do = (t.clone(memory_format=torch.contiguous_format)
                       if n in p.copies else t
                       for n, t in zip(BWD_OPERANDS, (q, k, v, do)))
        p = bwd_plan(q, k, v, do)
    return q, k, v, do, p


def _bwd_args(p: BwdPlan, q, k, v, o, do) -> ctypes.Array:
    """The launchers' plan (csrc/flash_attention_bwd.cu: Args): the
    shapes, the tile counts of ``p``, which the launchers check against
    their own, the operands' (batch, seq, head) strides, the design, and
    ``p``'s TMA maps (zeros where it has none: the delta kernel and the
    ``mma`` designs read through the strides); the ``mma`` designs append
    their packing, dkdv's (strips and KV heads a block, stages, blocks,
    shared memory) and dq's (strips, heads and KV heads a block, stages,
    blocks, shared memory), which the launchers check too."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    # eight maps of 11 values (TensorMap.packed), zeros where there are none
    maps = ([x for m in p.maps for x in m.packed()] if p.maps
            else [0] * (2 * len(BWD_OPERANDS) * 11))
    pack = []
    if p.mma:
        dk_p, dq_p = p.mma
        pack = [dk_p.strips_per_block, dk_p.heads_per_block, dk_p.stages,
                dk_p.blocks, dk_p.smem, dq_p.strips_per_block,
                dq_p.heads_per_block, dq_p.kv_heads_per_block, dq_p.stages,
                dq_p.blocks, dq_p.smem]
    return _longs([b, sq, sk, h, kh, d, _DTYPES[q.dtype], p.n_q_tiles,
                   p.n_k_tiles]
                  + [st for t in (q, k, v, o, do) for st in t.stride()[:3]]
                  + [BWD_DESIGNS.index(p.design), p.dq_q_tiles] + maps
                  + pack)


def _bwd_launch(symbol: str, wrapper, ptrs: list, args, scale=None,
                kind=None):
    fn = _build.kernel_fn("flash_attention_bwd", symbol,
                          [ctypes.c_void_p] * (len(ptrs) + 1)
                          + ([] if scale is None else [ctypes.c_float])
                          + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    rc = (fn(*ptrs, args, stream) if scale is None
          else fn(*ptrs, args, scale, stream))
    _build.check(rc, "flash_attention_bwd", symbol)
    count_launch(wrapper, kind)


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o): (B, Sq, H, D) o and dO -> (B, H, Sq) f32.
    A CPU tensor takes ``ref.ref_flash_bwd_delta``; a CUDA tensor launches
    ``flash_bwd_delta_kernel`` (counted in ``flash_bwd_delta.launches``)."""
    _bwd_check(o, o, o, like_q=(do,))
    if o.device.type == "cpu":
        return ref.ref_flash_bwd_delta(o, do)
    b, sq, h, d = o.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    if delta.numel() == 0:
        return delta
    o, do = _vec_ready(o, do)
    # the delta kernel reads only the plan's shape and o's and dO's
    # strides: o stands in for q, k and v
    _bwd_launch("flash_bwd_delta_launch", flash_bwd_delta,
                [o.data_ptr(), do.data_ptr(), delta.data_ptr()],
                _bwd_args(bwd_plan(o, o, o, do), o, o, o, o, do))
    return delta


def flash_bwd_dkdv(q, k, v, do, lse, delta):
    """(dk, dv), (B, Sk, K, D) in k's dtype, of the causal attention of q,
    k, v given dO, the forward's lse and delta (each (B, H, Sq) f32). A CPU
    tensor takes the plain backward's; a CUDA tensor launches the kernel
    of its design, ``flash_bwd_dkdv_wgmma_kernel`` for bf16 and
    ``flash_bwd_dkdv_wgmma_f32_kernel`` for f32 at D 64, 112 and 128,
    ``flash_bwd_dkdv_mma_kernel`` at D 8, 16 and 32
    (``flash_bwd_dkdv.launches`` and ``.by_design``), or raises."""
    _bwd_check(q, k, v, like_q=(do,), rows=(lse, delta))
    if q.device.type == "cpu":
        _, dk, dv = _ref_bwd(q, k, v, do, lse, delta)
        return dk, dv
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    q, k, v, do, p = bwd_ready(q, k, v, do)
    _bwd_launch("flash_bwd_dkdv_launch", flash_bwd_dkdv,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()],
                _bwd_args(p, q, k, v, do, do), q.shape[3] ** -0.5, p.design)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta):
    """dq, (B, Sq, H, D) in q's dtype, of the causal attention of q, k, v
    given dO, lse and delta. A CPU tensor takes the plain backward's; a
    CUDA tensor launches ``flash_bwd_dq_wgmma_kernel`` for bf16 and
    ``flash_bwd_dq_wgmma_f32_kernel`` for f32 at D 64, 112 and 128,
    ``flash_bwd_dq_mma_kernel`` at D 8, 16 and 32 (``flash_bwd_dq.launches``
    and ``.by_design``), or raises."""
    _bwd_check(q, k, v, like_q=(do,), rows=(lse, delta))
    if q.device.type == "cpu":
        return _ref_bwd(q, k, v, do, lse, delta)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    if k.shape[1] == 0:
        return dq.zero_()
    q, k, v, do, p = bwd_ready(q, k, v, do)
    _bwd_launch("flash_bwd_dq_launch", flash_bwd_dq,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
                _bwd_args(p, q, k, v, do, do), q.shape[3] ** -0.5, p.design)
    return dq


def _ref_bwd(q, k, v, do, lse, delta):
    return ref.ref_flash_attention_bwd(q, k, v, None, lse, do, delta=delta)


for _w in (flash_bwd_delta, flash_bwd_dkdv, flash_bwd_dq):
    _w.launches = 0
for _w in (flash_bwd_dkdv, flash_bwd_dq):
    _w.by_design = dict.fromkeys(BWD_DESIGNS, 0)


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal flash attention, from the forward's o and
    lse (B, H, Sq) and the output's gradient dO. A CPU tensor takes
    ``ref.ref_flash_attention_bwd``; a CUDA tensor launches the delta,
    dkdv and dq kernels, in that order, or raises."""
    _bwd_check(q, k, v, like_q=(o, do), rows=(lse,))
    if q.device.type == "cpu":
        return ref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    delta = flash_bwd_delta(o, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta)
    return flash_bwd_dq(q, k, v, do, lse, delta), dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal flash attention with the hand-written backward. forward(q,
    k, v) -> o saves q, k, v, o and the lse; backward(dO) -> (dq, dk, dv)
    through :func:`flash_attention_bwd`. On CPU tensors both are the plain
    versions (the backward is ``ref.ref_flash_attention_bwd``, not autograd
    through the plain forward); on CUDA tensors both launch kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _forward(q, k, v, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do)


# ---------------------------------------------------------------------------
# under fake tensors (the dry run, launch/dryrun.py): shapes and FLOPs only
# ---------------------------------------------------------------------------

def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


_SHAPE_OPS: dict = {}


def shape_ops():
    """The ``torch.library`` ops ``repro_torch::flash_fwd_shape(q, k, v)
    -> o`` and ``repro_torch::flash_bwd_shape(q, k, v, do) -> (dq, dk,
    dv)``: each has only a fake implementation (the outputs' shapes), for
    a fake-tensor trace, where no tensor has a device to launch on, and a
    FLOP formula for ``torch.utils.flop_counter``'s registry from
    :func:`causal_pairs`: 4 B H D pairs forward; 10 B H D pairs
    backward (S recomputed, dS, dV, dQ and dK). Registered on first use;
    called on real tensors they raise."""
    if _SHAPE_OPS:
        return _SHAPE_OPS["fwd"], _SHAPE_OPS["bwd"]
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::flash_fwd_shape", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
        raise RuntimeError("flash_fwd_shape runs under fake tensors only")

    @fwd.register_fake
    def _(q, k, v):
        return torch.empty_like(q)

    @torch.library.custom_op("repro_torch::flash_bwd_shape", mutates_args=())
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        raise RuntimeError("flash_bwd_shape runs under fake tensors only")

    @bwd.register_fake
    def _(q, k, v, do):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def flops(mult):
        def formula(q_shape, k_shape, *args, **kwargs):
            b, sq, h, d = q_shape
            return mult * b * h * d * causal_pairs(sq, k_shape[1])
        return formula

    register_flop_formula(torch.ops.repro_torch.flash_fwd_shape)(flops(4))
    register_flop_formula(torch.ops.repro_torch.flash_bwd_shape)(flops(10))
    _SHAPE_OPS.update(fwd=torch.ops.repro_torch.flash_fwd_shape,
                      bwd=torch.ops.repro_torch.flash_bwd_shape)
    return _SHAPE_OPS["fwd"], _SHAPE_OPS["bwd"]


class ShapeOnlyFlashFn(torch.autograd.Function):
    """Flash attention on fake tensors: :func:`shape_ops`' forward and
    backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return shape_ops()[0](q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return shape_ops()[1](q, k, v, do)
