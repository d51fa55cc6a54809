"""The flash wrapper's host-side launch plan, on the CPU.

``repro_torch.kernels.flash_attention.plan`` decides everything the
tensor-core kernels are told from the host: which design a (dtype, head
dim) takes, the heaviest-first order of the blocks and their causal trip
counts, the TMA tensor maps (dims, byte strides, boxes) with their
alignment, and the ``mma`` designs' packing of 16-row query strips and
heads into blocks (``mma_plan``, ``mma_units``; bf16 and f32). It is a
pure function of shapes, strides and addresses, so it is tested here;
the kernels themselves run only on the card (``chip_smoke.py``). The
kernels' numerics are emulated here instead: the bf16 kernels' P
operand, split into two bf16 parts, gives the plain version's f32
product within one bf16 ulp, where P rounded to bf16 once would not; the
``mma`` kernel's
arithmetic (q scaled in f32, q and P each as three bf16 parts that sum
to them exactly, 32-key tiles) holds one bf16 ulp against the plain
version and the JAX package's Pallas body; the f32 kernels' three TF32
products of hi and lo parts hold the f32 tolerance against the plain
version and the JAX package, where one TF32 product does not. The f32
``mma`` kernel's fragment index maps (ldmatrix of f32 rows, the S
accumulator taken as P's A fragment, V read at the permuted keys) are
checked exactly in numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.float32, 16, "mma_f32"), (torch.float32, 32, "mma_f32"),
    (torch.float32, 64, "wgmma_f32"), (torch.float32, 128, "wgmma_f32"),
])
def test_design_is_chosen_by_dtype_and_head_dim(dtype, d, want):
    assert fa.design(dtype, d) == want
    q = torch.zeros(1, 5, 4, d, dtype=dtype)
    kv = torch.zeros(1, 7, 2, d, dtype=dtype)
    p = fa.plan(q, kv, kv)
    assert p.design == want
    tma = want in ("wgmma", "wgmma_f32")
    assert (p.maps is not None) == tma
    assert (p.mma is not None) == (want in fa.MMA_DESIGNS)
    assert p.n_q_tiles == 1
    # the launcher's args: the same choice, the shapes and the strides
    args = list(p.args)
    assert args[:8] == [1, 5, 7, 4, 2, d, int(dtype == torch.bfloat16),
                        fa.DESIGNS.index(want)]
    assert args[9:18] == [*q.stride()[:3], *kv.stride()[:3], *kv.stride()[:3]]
    # the mma designs: their block count (one strip of all 4 heads, which
    # read 2 KV heads) and their packing after the 51 shared values, the
    # shared memory at the dtype's element size
    if want in fa.MMA_DESIGNS:
        mp = fa.mma_plan(5, 7, 4, 2, 1, d, q.element_size())
        assert p.mma == mp and args[8] == mp.blocks == 1
        assert args[51:] == [1, 4, 2, 1, mp.smem]
        assert mp.smem == mma_smem(mp, d, q.element_size())
    assert len(args) == (56 if want in fa.MMA_DESIGNS else 51)
    # maps: q, k and v for bf16 at D 64/128; k and v for f32 there (q is
    # read through its strides); none at D 16/32
    assert [any(args[18 + 11 * i:29 + 11 * i]) for i in range(3)] == [
        want == "wgmma", tma, tma]


def visible_tiles(rows, sq, sk, bk):
    """Key tiles that hold a key visible to any of ``rows`` (brute force)."""
    last = max((i + sk - sq for i in rows), default=-1)
    return 0 if last < 0 else min(last // bk + 1, -(-sk // bk))


@pytest.mark.parametrize("sq,sk", [
    (1, 1), (1, 129), (129, 200), (300, 1000), (257, 257), (300, 130),
    (150, 40), (128, 128), (32768, 32768), (5, 0),
])
def test_trip_counts_cover_exactly_the_visible_key_tiles(sq, sk):
    n_q = -(-sq // fa.BLOCK_Q)
    pairs = 0
    for t in range(n_q):
        rows = range(t * fa.BLOCK_Q, min((t + 1) * fa.BLOCK_Q, sq))
        trips = fa.trip_count(t, sq, sk)
        if sq <= 1024:
            assert trips == visible_tiles(rows, sq, sk, fa.BLOCK_K)
        # every visible pair lies in a visited tile, and no visited tile
        # starts past the key axis
        assert trips * fa.BLOCK_K >= min(rows[-1] + sk - sq + 1, sk)
        assert trips == 0 or (trips - 1) * fa.BLOCK_K < sk
        pairs += sum(max(0, min(i + sk - sq + 1, sk, trips * fa.BLOCK_K))
                     for i in rows) if sq <= 1024 else 0
    if sq <= 1024:
        assert pairs == fa.causal_pairs(sq, sk)


@pytest.mark.parametrize("sq,sk,h,b", [(300, 1000, 8, 3), (32768, 32768, 32, 1),
                                       (300, 130, 4, 2), (1, 1, 4, 1)])
def test_launch_order_is_heaviest_first_and_covers_every_block(sq, sk, h, b):
    order = fa.launch_order(sq, h, b)
    n_q = -(-sq // fa.BLOCK_Q)
    assert len(order) == n_q * h * b
    assert sorted(order) == sorted((t, hh, bb) for t in range(n_q)
                                   for hh in range(h) for bb in range(b))
    trips = [fa.trip_count(t, sq, sk) for t, _, _ in order]
    assert trips == sorted(trips, reverse=True)
    assert order[0][0] == n_q - 1
    # the query heads of one KV head (group 4) launch side by side
    assert [hh for _, hh, _ in order[:h]] == list(range(h))


def p_kv(*shape):
    return torch.zeros(shape, dtype=BF16), torch.zeros(shape, dtype=BF16)


def test_tensor_maps_of_contiguous_and_strided_operands():
    q = torch.zeros(2, 300, 8, 64, dtype=BF16)
    m = fa.tensor_map(q)
    assert m.dims == (64, 8, 300, 2)
    assert m.strides == (64 * 2, 8 * 64 * 2, 300 * 8 * 64 * 2)
    assert m.box == (fa.BOX_COLS, 1, fa.BLOCK_Q, 1)
    assert len(m.packed()) == 11
    # every other head of a wider tensor: read through its strides
    wide = torch.zeros(2, 300, 16, 128, dtype=BF16)
    qs = wide[:, :, ::2]
    m = fa.tensor_map(qs)
    assert m.dims == (128, 8, 300, 2)
    assert m.strides == (2 * 128 * 2, 16 * 128 * 2, 300 * 16 * 128 * 2)
    # a dim of size 1 is never stepped over: its stride is the contiguous
    # one, whatever torch reports
    one = torch.zeros(1, 10, 1, 64, dtype=BF16).as_strided(
        (1, 10, 1, 64), (7, 64, 3, 1))
    assert fa.tensor_map(one).strides == (64 * 2, 64 * 2, 10 * 64 * 2)
    p = fa.plan(qs, *p_kv(2, 300, 2, 128))
    assert p.copies == () and p.n_q_tiles == 3
    args = list(p.args)
    assert args[:9] == [2, 300, 300, 8, 2, 128, 1, 0, 3]
    assert args[9:12] == list(qs.stride()[:3])
    assert len(args) == 51 and args[18:29] == fa.tensor_map(qs).packed()
    assert fa.plan(qs, *p_kv(2, 300, 2, 128)) is p    # cached by layout


def test_misaligned_operands_are_copied_not_refused():
    q = torch.randn(1, 150, 8, 64).to(BF16)
    buf = torch.randn(150 * 2 * 64 + 1).to(BF16)
    k = buf[1:].view(1, 150, 2, 64)          # base 2 bytes past 16
    v = torch.randn(1, 150, 2, 68).to(BF16)[..., :64]  # rows 136 bytes
    assert k.data_ptr() % fa.TMA_ALIGN != 0
    p = fa.plan(q, k, v)
    assert p.copies == ("k", "v") and p.maps is None
    assert p.args is None
    q2, k2, v2, p2 = fa.tma_ready(q, k, v)
    assert p2.copies == () and p2.maps is not None
    assert q2 is q and k2 is not k and v2 is not v
    assert torch.equal(k2, k) and torch.equal(v2, v)
    assert k2.data_ptr() % fa.TMA_ALIGN == 0
    # fresh f32 copies (the f32 tensor-core design maps k and v) are
    # aligned: nothing is copied
    assert fa.plan(q.float(), k.float(), v.float()).copies == ()


def test_queries_before_every_key_plan_no_key_tile():
    sq, sk = 300, 130
    assert [fa.trip_count(t, sq, sk) for t in range(3)] == [0, 1, 2]
    q = torch.zeros(2, sq, 4, 64, dtype=BF16)
    kv = torch.zeros(2, sk, 1, 64, dtype=BF16)
    p = fa.plan(q, kv, kv)
    assert p.n_q_tiles == 3
    assert p.maps[1].dims == (64, 1, sk, 2)
    # an empty key axis still encodes (extent 1; no tile is loaded)
    e = torch.zeros(2, 0, 1, 64, dtype=BF16)
    assert fa.plan(q, e, e).maps[1].dims[2] == 1


def test_cpu_call_counts_no_launch_of_either_design():
    tops.flash_attention.launches = 0
    before = dict(tops.flash_attention.by_design)
    q = torch.randn(1, 9, 4, 64).to(BF16)
    kv = torch.randn(1, 9, 2, 64).to(BF16)
    tops.flash_attention(q, kv, kv)
    tops.flash_attention(q.float(), kv.float(), kv.float())
    assert tops.flash_attention.launches == 0
    assert tops.flash_attention.by_design == before


def split_p(p):
    """The tensor-core kernel's P operand: two bf16 parts, hi = bf16(p) and
    lo = bf16(p - hi), each multiplied with V."""
    hi = p.to(BF16).float()
    return hi, (p - hi).to(BF16).float()


def full_logits_flash(q, k, v, bk, p_mode):
    """The tiled online softmax's result written in closed form from the
    full logits: each p is taken against the running max of the key tiles
    up to its own, rescaled to the final max in f32, l sums the f32 p, and
    the P operand of the product with V is ``p_mode``: "f32", "split" (the
    kernel's hi + lo) or "bf16" (p rounded once)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, d) * d ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    mask = qpos >= torch.arange(sk)[None, :]
    logits = torch.where(mask, logits, tref.NEG)
    n_t = -(-sk // bk)
    pad = n_t * bk - sk
    tiles = torch.nn.functional.pad(logits, (0, pad), value=tref.NEG)
    tile_max = tiles.unflatten(-1, (n_t, bk)).amax(-1)
    run_max = torch.cummax(tile_max, -1).values
    m_of = run_max.repeat_interleave(bk, -1)[..., :sk]
    p = torch.where(mask, torch.exp(logits - m_of), 0.0)
    scale = torch.exp(m_of - run_max[..., -1:])
    l = (p * scale).sum(-1)
    parts = {"f32": (p,), "split": split_p(p), "bf16": (p.to(BF16).float(),)}
    acc = sum(torch.einsum("bkgqs,bskd->bkgqd", part * scale, v.float())
              for part in parts[p_mode])
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def within_ulps(got, want, n):
    """|got - want| <= 1e-5 + n * 2^-7 |want| everywhere (chip_smoke.py's
    FLASH_TOL[bf16] at n = 1)."""
    want = want.float()
    return bool(((got.float() - want).abs()
                 <= 1e-5 + n * 2 ** -7 * want.abs()).all())


def split3(x):
    """x (f32) as the mma kernel's three bf16 parts, largest first:
    bf16(x), then bf16 of each remainder; their sum is x exactly, but
    near f32's smallest normals."""
    parts = []
    for _ in range(3):
        parts.append(x.to(BF16).float())
        x = x - parts[-1]
    return parts


def emulated_mma_flash(q, k, v):
    """The ``mma`` kernel's arithmetic on the host: q scaled by D^-0.5
    in f32 and split into three bf16 parts, S the sum of the parts'
    products with K (each exact in f32), the smallest first; the online
    softmax over 32-key tiles written in closed form (each p = exp(s - m)
    against its tile's running max m, which starts at -1e30, rescaled to
    the final max), l summing the f32 p, and P split into three parts for
    the product with V."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g, bk = h // kh, fa.MMA_BK
    qs = q.float() * d ** -0.5
    parts = split3(qs)
    assert torch.equal(parts[0] + parts[1] + parts[2], qs)
    s = sum(torch.einsum("bqkgd,bskd->bkgqs", part.reshape(b, sq, kh, g, d),
                         k.float()) for part in reversed(parts))
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    mask = qpos >= torch.arange(sk)[None, :]
    s = torch.where(mask, s, -torch.inf)
    n_t = -(-sk // bk)
    tiles = torch.nn.functional.pad(s, (0, n_t * bk - sk), value=-torch.inf)
    run_max = torch.clamp(torch.cummax(tiles.unflatten(-1, (n_t, bk))
                                       .amax(-1), -1).values, min=tref.NEG)
    m_of = run_max.repeat_interleave(bk, -1)[..., :sk]
    p = torch.where(mask, torch.exp(s - m_of), 0.0)
    rescale = torch.exp(m_of - run_max[..., -1:])
    l = (p * rescale).sum(-1)
    acc = sum(torch.einsum("bkgqs,bskd->bkgqd", part * rescale, v.float())
              for part in reversed(split3(p)))
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [
    (1, 129, 200, 8, 2, 64), (2, 257, 257, 4, 1, 64),
    (1, 300, 700, 4, 4, 128), (2, 100, 40, 4, 2, 64),
    # the mma design: the Meta-pipe encoder's S 32 x 8 heads at D 32,
    # D 16 with GQA, and Sk > Sq, Sq > Sk across its strips and tiles
    (4, 32, 32, 8, 8, 32), (2, 32, 32, 8, 2, 16), (1, 65, 100, 6, 3, 32),
    (2, 17, 5, 10, 5, 16),
])
def test_split_p_keeps_the_plain_versions_f32_product(b, sq, sk, h, kh, d):
    """The plain version keeps P in f32 and is unchanged: it equals the
    closed form. The tensor-core kernels' hi + lo split of P gives the same
    bf16 outputs within one ulp; P rounded to bf16 once, as FlashAttention
    does, would not hold even within two. At D 16 and 32 the mma kernel's
    own arithmetic (q scaled in f32, q and P each as three bf16 parts)
    holds FLASH_TOL[bf16] against the plain version and the JAX package's
    Pallas body (interpret)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    got32 = tref.ref_flash_attention(q, k, v)
    assert float((got32 - full_logits_flash(q, k, v, 128, "f32"))
                 .abs().max()) < 1e-5
    q, k, v = (x.to(BF16) for x in (q, k, v))
    plain = tref.ref_flash_attention(q, k, v)
    assert plain.dtype == BF16
    assert torch.equal(tops.flash_attention(q, k, v), plain)
    assert within_ulps(plain, full_logits_flash(q, k, v, 128, "f32")
                       .to(BF16), 1)
    assert within_ulps(full_logits_flash(q, k, v, 128, "split").to(BF16),
                       plain, 1)
    assert not within_ulps(full_logits_flash(q, k, v, 128, "bf16")
                           .to(BF16), plain, 2)
    if fa.design(BF16, d) == "mma":
        mma = emulated_mma_flash(q, k, v).to(BF16)
        pallas = jops.flash_attention(
            *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (q, k, v)), interpret=True)
        assert within_ulps(mma, plain, 1)
        assert within_ulps(mma, torch.as_tensor(
            np.array(pallas.astype(jnp.float32))), 1)


# -- the short-sequence design ("mma") ----------------------------------------

def mma_smem(p, d, es):
    """The mma kernels' shared memory in bytes: the block's query rows,
    then per stage a K and a V tile of each KV head, every row of D
    elements of ``es`` bytes padded by 16 bytes, each head's region
    skewed by 16."""
    pad = 16 // es
    rs = d + pad
    return es * (p.warps * fa.MMA_ROWS * rs + p.heads_per_block * pad
                 + p.stages * 2 * p.kv_heads_per_block
                 * (fa.MMA_BK * rs + pad))


def check_mma_cover(b, sq, sk, h, kh, d=32, es=2):
    """mma_plan and mma_units: every (16-row strip, head, batch) on
    exactly one warp; a block one batch element, its KV heads within its
    shared memory; idle warps only past the last strip. ``es``: the
    element size (2: bf16, the ``mma`` design; 4: f32, ``mma_f32``)."""
    p = fa.mma_plan(sq, sk, h, kh, b, d, es)
    units = fa.mma_units(p, b)
    strips = -(-sq // fa.MMA_ROWS)
    assert p.strips == strips and len(units) == p.blocks
    assert p.blocks == p.strip_groups * p.head_groups * b
    assert 1 <= p.warps <= fa.MMA_WARPS and h % p.heads_per_block == 0
    assert p.strips_per_block == min(strips, fa.MMA_WARPS)
    live = [u for blk in units for u in blk if u is not None]
    assert len(live) == len(set(live)) == strips * h * b
    assert set(live) == {(s, hh, bb) for s in range(strips)
                         for hh in range(h) for bb in range(b)}
    g = h // kh
    for blk in units:
        mine = [u for u in blk if u is not None]
        assert mine and len({bb for _, _, bb in mine}) == 1
        assert len({hh // g for _, hh, _ in mine}) <= p.kv_heads_per_block
    idle = sum(u is None for blk in units for u in blk)
    assert idle == ((p.strip_groups * p.strips_per_block - strips)
                    * p.heads_per_block * p.head_groups * b)
    # the strip group with the most key tiles first
    firsts = [min(u[0] for u in blk if u is not None) for blk in units]
    assert firsts == sorted(firsts, reverse=True)
    assert p.stages == (2 if -(-sk // fa.MMA_BK) > 1 else 1)
    assert p.smem == mma_smem(p, d, es) and fa.MMA_PAD == 16
    assert p.smem <= 232448
    return p


@pytest.mark.parametrize("h,kh", [(8, 8), (8, 2), (6, 3)])
@pytest.mark.parametrize("sq", [1, 15, 16, 17, 31, 32, 33, 64, 65])
def test_mma_plan_covers_every_strip_head_and_batch_once(sq, h, kh):
    check_mma_cover_at(sq, h, kh, 2)


@pytest.mark.parametrize("h,kh", [(8, 8), (8, 2), (6, 3)])
@pytest.mark.parametrize("sq", [1, 15, 16, 17, 31, 32, 33, 64, 65])
def test_mma_f32_plan_covers_every_strip_head_and_batch_once(sq, h, kh):
    """The same packing in f32 (``mma_f32``): only the shared memory
    differs."""
    check_mma_cover_at(sq, h, kh, 4)


def check_mma_cover_at(sq, h, kh, es):
    for sk in (sq, sq + 40, max(sq - 10, 0)):
        p = check_mma_cover(3, sq, sk, h, kh, 32, es)
        # at S 32 the block is full: 2 strips of 4 heads (8 heads) or of
        # 3 heads (6 heads: 3 divides 6, 4 does not)
        if sq == 32:
            assert (p.strips_per_block, p.heads_per_block) == (
                2, 4 if h == 8 else 3)
            assert p.warps == 2 * p.heads_per_block and p.head_groups == 2


def test_mma_plan_at_the_encoders_shape():
    """B 4,096 x S 32 x H 8 / K 8, D 32: 8,192 blocks of 2 strips x 4
    heads, 8 warps and none idle, each block reading its 4 KV heads once,
    one K/V stage."""
    check_mma_plan_at_the_encoders_shape(torch.bfloat16, "mma", 30_912)


def test_mma_f32_plan_at_the_encoders_shape():
    """The same packing in f32: rows of 36 floats (144 bytes), q 8 x 16
    rows (18.5 KB) and K and V of 4 heads (37.0 KB), four blocks an SM by
    shared memory."""
    check_mma_plan_at_the_encoders_shape(torch.float32, "mma_f32", 55_488)


def check_mma_plan_at_the_encoders_shape(dtype, want, smem):
    es = torch.empty((), dtype=dtype).element_size()
    p = check_mma_cover(4096, 32, 32, 8, 8, 32, es)
    assert (p.blocks, p.warps, p.strips_per_block, p.heads_per_block,
            p.kv_heads_per_block, p.stages) == (8192, 8, 2, 4, 4, 1)
    assert p.smem == smem and 232448 // p.smem >= 4
    q = torch.zeros(4096, 32, 8, 32, dtype=dtype)
    fp = fa.plan(q, q, q)
    assert fp.design == want and fp.mma == p and fp.copies == ()
    assert list(fp.args)[8] == 8192 and list(fp.args)[51:] == [
        2, 4, 4, 1, smem]


@pytest.mark.parametrize("sq,sk", [
    (1, 1), (1, 40), (16, 9), (17, 5), (32, 32), (33, 33), (33, 20),
    (65, 100), (65, 40), (129, 257), (300, 1000), (5, 0),
])
def test_mma_trip_counts_cover_exactly_the_visible_key_tiles(sq, sk):
    """Each warp's 16-row strip visits the 32-key tiles that hold a key
    visible to one of its rows; its block loads those of its last strip;
    the visited pairs are the causal pairs."""
    p = fa.mma_plan(sq, sk, 4, 2, 1, 32)
    pairs = 0
    for blk in fa.mma_units(p, 1):
        mine = [u for u in blk if u is not None]
        trips = {s: fa.trip_count(s, sq, sk, fa.MMA_ROWS, fa.MMA_BK)
                 for s, _, _ in mine}
        assert max(trips.values()) == trips[max(trips)]
        assert max(trips.values()) <= 1 or p.stages == 2
        for s, hh, _ in mine:
            rows = range(s * fa.MMA_ROWS, min((s + 1) * fa.MMA_ROWS, sq))
            assert trips[s] == visible_tiles(rows, sq, sk, fa.MMA_BK)
            if hh == 0:
                pairs += sum(max(0, min(i + sk - sq + 1, sk,
                                        trips[s] * fa.MMA_BK)) for i in rows)
    assert pairs == fa.causal_pairs(sq, sk)


def test_mma_operands_off_16_bytes_are_copied():
    """The mma kernel's 16-byte copies: a q that is a view of a fused qkv
    projection (row stride (H + 2K) D) is read as it lies; a k whose base
    is 8 bytes past a 16-byte boundary, or a v whose rows are not a
    multiple of 16 bytes apart, is copied first."""
    x = torch.zeros(2, 48, (8 + 2 * 2) * 32, dtype=BF16)
    q = x[..., :256].view(2, 48, 8, 32)
    k = x[..., 256:320].view(2, 48, 2, 32)
    v = x[..., 320:].view(2, 48, 2, 32)
    p = fa.plan(q, k, v)
    assert p.copies == () and list(p.args)[9:12] == list(q.stride()[:3])
    km = torch.zeros(48 * 2 * 32 + 4, dtype=BF16)[4:].view(1, 48, 2, 32)
    assert km.data_ptr() % fa.TMA_ALIGN == 8
    vm = torch.zeros(1, 48, 2, 36, dtype=BF16)[..., :32]
    qq = torch.zeros(1, 48, 8, 32, dtype=BF16)
    p = fa.plan(qq, km, vm)
    assert p.copies == ("k", "v") and p.args is None and p.mma is not None
    q2, k2, v2, p2 = fa.tma_ready(qq, km, vm)
    assert p2.copies == () and q2 is qq and torch.equal(k2, km)
    assert k2.data_ptr() % fa.TMA_ALIGN == 0 and torch.equal(v2, vm)
    # fresh f32 copies are aligned: nothing is copied
    assert fa.plan(qq.float(), km.float(), vm.float()).copies == ()
    # mma_f32 copies 4 floats a piece: the same rules in f32, a fused qkv
    # read as it lies, a k 8 bytes off and rows of 33 floats copied
    xf = x.float()
    qf, kf, vf = (xf[..., :256].view(2, 48, 8, 32),
                  xf[..., 256:320].view(2, 48, 2, 32),
                  xf[..., 320:].view(2, 48, 2, 32))
    p = fa.plan(qf, kf, vf)
    assert p.design == "mma_f32" and p.copies == ()
    kmf = torch.zeros(48 * 2 * 32 + 2)[2:].view(1, 48, 2, 32)
    assert kmf.data_ptr() % fa.TMA_ALIGN == 8
    vmf = torch.zeros(1, 48, 2, 33)[..., :32]
    p = fa.plan(qq.float(), kmf, vmf)
    assert p.copies == ("k", "v") and p.args is None
    q2, k2, v2, p2 = fa.tma_ready(qq.float(), kmf, vmf)
    assert p2.copies == () and p2.design == "mma_f32"
    assert torch.equal(k2, kmf) and torch.equal(v2, vmf)
    assert k2.data_ptr() % fa.TMA_ALIGN == 0


# -- the f32 tensor-core design ("wgmma_f32") ---------------------------------

F32 = torch.float32
#: chip_smoke.py's FLASH_TOL[float32]: |kernel - plain| <= atol + rtol |plain|
#: (sums in another order)
F32_TOL = (2e-5, 1e-5)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [
    (1, 1), (1, 300), (129, 200), (300, 1000), (257, 257), (300, 130),
    (65, 97), (63, 65), (5, 0), (32768, 32768),
])
def test_f32_tiles_and_trip_counts_cover_the_visible_keys(d, sq, sk):
    bq, bk = fa.block_shape(F32, d)
    assert (bq, bk) == fa.F32_TILES[d] and bq % 64 == 0 and bk % 32 == 0
    n_q = -(-sq // bq)
    p = fa.plan(torch.zeros(1, sq, 4, d), *(torch.zeros(1, sk, 2, d),) * 2)
    assert p.design == "wgmma_f32" and p.n_q_tiles == n_q
    assert list(p.args)[8] == n_q
    pairs = 0
    for t in range(n_q):
        rows = range(t * bq, min((t + 1) * bq, sq))
        trips = fa.trip_count(t, sq, sk, bq, bk)
        if sq <= 1024:
            assert trips == visible_tiles(rows, sq, sk, bk)
            pairs += sum(max(0, min(i + sk - sq + 1, sk, trips * bk))
                         for i in rows)
        assert trips * bk >= min(rows[-1] + sk - sq + 1, sk)
        assert trips == 0 or (trips - 1) * bk < sk
    if sq <= 1024:
        assert pairs == fa.causal_pairs(sq, sk)
    order = fa.launch_order(sq, 4, 2, bq)
    trips = [fa.trip_count(t, sq, sk, bq, bk) for t, _, _ in order]
    assert trips == sorted(trips, reverse=True) and len(order) == n_q * 8


def test_f32_tensor_maps_use_32_column_boxes_of_128_bytes():
    for d in (64, 128):
        bq, bk = fa.F32_TILES[d]
        q = torch.zeros(2, 300, 8, d)
        k = torch.zeros(2, 300, 2, d)
        m = fa.tensor_map(k, bk)
        assert m.box == (32, 1, bk, 1) and m.box[0] * 4 == fa.SWIZZLE_BYTES
        assert m.dims == (d, 2, 300, 2)
        assert m.strides == (d * 4, 2 * d * 4, 300 * 2 * d * 4)
        p = fa.plan(q, k, k)
        args = list(p.args)
        assert p.maps[0] is None and p.maps[1] == m and p.maps[2] == m
        assert args[18:29] == [0] * 11
        assert args[29:40] == m.packed() and args[40:51] == m.packed()
        assert args[:9] == [2, 300, 300, 8, 2, d, 0, 2, -(-300 // bq)]
        # every other head of a wider tensor: read through its strides
        ks = torch.zeros(2, 300, 4, d)[:, :, ::2]
        ms = fa.tensor_map(ks, bk)
        assert ms.dims == (d, 2, 300, 2) and ms.box == (32, 1, bk, 1)
        assert ms.strides == (2 * d * 4, 4 * d * 4, 300 * 4 * d * 4)
        assert fa.plan(q, ks, ks).copies == ()
        # a strided or misaligned q is read through its strides, as it lies
        qs = torch.zeros(2, 300, 16, d)[:, :, ::2]
        qm = torch.zeros(2 * 300 * 8 * d + 1)[1:].view(2, 300, 8, d)
        assert qm.data_ptr() % fa.TMA_ALIGN != 0
        for qq in (qs, qm):
            p = fa.plan(qq, k, k)
            assert p.copies == () and list(p.args)[9:12] == list(
                qq.stride()[:3])
        # a k whose base TMA cannot read, and a v whose rows are 4 bytes
        # off 16, are copied
        km = torch.zeros(2 * 300 * 2 * d + 1)[1:].view(2, 300, 2, d)
        vm = torch.zeros(2, 300, 2, d + 1)[..., :d]
        p = fa.plan(q, km, vm)
        assert p.copies == ("k", "v") and p.args is None
        q2, k2, v2, p2 = fa.tma_ready(q, km, vm)
        assert p2.copies == () and q2 is q and torch.equal(k2, km)
        assert k2.data_ptr() % fa.TMA_ALIGN == 0 and torch.equal(v2, vm)


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: by bit arithmetic on the
    f32 pattern (the carry of the round bit may step the exponent)."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0x1000) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32).reshape(x.shape)


def tc_product(eq, a, b, products):
    """einsum on the tensor cores' TF32 operands: one product of the
    rounded operands, or the kernel's three of their hi and lo parts
    (a_lo b_hi + a_hi b_lo + a_hi b_hi), each exact in f32 and summed in
    f32."""
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def emulated_f32_flash(q, k, v, bk, products):
    """The f32 kernel's arithmetic on the host: q scaled by D^-0.5, S = Q
    K^T on TF32 operands, the online softmax over bk-key tiles written in
    closed form (each p against its tile's running max, rescaled to the
    final max), l summing the f32 p, P V on TF32 operands."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = (q * d ** -0.5).reshape(b, sq, kh, g, d)
    logits = tc_product("bqkgd,bskd->bkgqs", qf, k, products)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    mask = qpos >= torch.arange(sk)[None, :]
    logits = torch.where(mask, logits, tref.NEG)
    n_t = -(-sk // bk)
    tiles = torch.nn.functional.pad(logits, (0, n_t * bk - sk),
                                    value=tref.NEG)
    run_max = torch.cummax(tiles.unflatten(-1, (n_t, bk)).amax(-1), -1).values
    m_of = run_max.repeat_interleave(bk, -1)[..., :sk]
    p = torch.where(mask, torch.exp(logits - m_of), 0.0)
    scale = torch.exp(m_of - run_max[..., -1:])
    l = (p * scale).sum(-1)
    ph = tf32(p)
    parts = [(ph, tf32(v))] if products == 1 else [
        (tf32(p - ph), tf32(v)), (ph, tf32(v - tf32(v))), (ph, tf32(v))]
    acc = sum(torch.einsum("bkgqs,bskd->bkgqd", pp * scale, vv)
              for pp, vv in parts)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def within_f32_tol(got, want):
    got, want = (torch.as_tensor(np.array(x, np.float32)) for x in (got, want))
    return bool(((got - want).abs()
                 <= F32_TOL[0] + F32_TOL[1] * want.abs()).all())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                   # TF32's ulp at 1
    x = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2 ** -23,
                      -(one + ulp / 2), one + 3 * ulp / 2, 3.0e38, 0.0,
                      -0.0, 1e-40])
    got = tf32(x)
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + 2 * ulp,
                         float(tf32(torch.tensor([3.0e38]))), 0.0, -0.0,
                         float(tf32(torch.tensor([1e-40])))])
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    # hi + lo is x to 2^-22 of it
    y = torch.as_tensor(np.random.default_rng(0).normal(size=4096)
                        .astype(np.float32))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [
    (1, 129, 200, 8, 2, 64), (2, 70, 70, 4, 1, 128),
    (1, 45, 130, 8, 2, 64), (1, 100, 40, 4, 4, 128),
    # mma_f32 at 32-key tiles: the Meta-pipe encoder's S 32 x 8 heads at
    # D 32, D 16 with GQA, Sq > Sk, and Sk > Sq across strips and tiles
    (4, 32, 32, 8, 8, 32), (2, 32, 32, 8, 2, 16), (1, 65, 40, 6, 3, 32),
    (2, 17, 50, 10, 5, 16), (1, 100, 300, 4, 4, 32),
])
def test_split_tf32_products_hold_the_f32_tolerance(b, sq, sk, h, kh, d):
    """The f32 kernels' three TF32 products (``wgmma_f32`` at D 64/128,
    ``mma_f32`` at D 16/32, each at its key tiles) stay within
    FLASH_TOL[f32] of the plain version, of the JAX package's
    ref_attention and of its Pallas body (interpret); one TF32 product
    does not."""
    rng = np.random.default_rng(7 * sq + sk + d)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    plain = tref.ref_flash_attention(tq, tk, tv)
    assert torch.equal(tops.flash_attention(tq, tk, tv), plain)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jax_ref = np.asarray(jref.ref_attention(jq, jk, jv))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, interpret=True))
    bk = (fa.MMA_BK if fa.design(F32, d) == "mma_f32"
          else fa.F32_TILES[d][1])
    split = emulated_f32_flash(tq, tk, tv, bk, 3)
    single = emulated_f32_flash(tq, tk, tv, bk, 1)
    # the rows before every key (Sq > Sk) are 0 in the kernel, the plain
    # version and the Pallas body, NaN in ref_attention: compared on the
    # rest
    blind = max(sq - sk, 0)
    assert not split[:, :blind].any() and np.isnan(jax_ref[:, :blind]).all()
    for want in (plain, pallas, jax_ref):
        assert within_f32_tol(split[:, blind:], np.asarray(want)[:, blind:])
        assert not within_f32_tol(single[:, blind:],
                                  np.asarray(want)[:, blind:])


def test_f32_bound_is_three_tf32_products():
    """The f32 flash bound: three TF32 products at the dense TF32 rate
    (494.7 / 3 TFLOP/s), faster than the CUDA cores' 67: 26.67 ms at the
    32k layer of llama3.2-1b, where the CUDA cores' bound was 65.64."""
    from repro_torch.launch import roofline
    flops = 4 * 1 * 32 * 64 * fa.causal_pairs(32768, 32768)
    peak = roofline.compute_peak("float32")
    assert peak == roofline.PEAK_TENSOR_TF32 / roofline.F32_SPLIT_PRODUCTS
    assert peak > roofline.PEAK_CUDA_CORE_OPS
    assert round(flops / peak * 1e3, 2) == 26.67
    assert round(flops / roofline.PEAK_CUDA_CORE_OPS * 1e3, 2) == 65.64
    assert roofline.compute_peak("bfloat16") == roofline.PEAK_TENSOR_BF16
    assert roofline.compute_peak("int32") == roofline.PEAK_CUDA_CORE_OPS


# -- the f32 short-sequence design ("mma_f32"): its fragments ----------------

def ldmatrix_x4(smem, addrs):
    """``ldmatrix.x4 .b16`` on f32 rows: lanes 8 i .. 8 i + 7 give the row
    addresses (in floats) of matrix i, an 8x8 b16 matrix of 8 rows of 4
    floats; lane (g = lane / 4, t = lane % 4) receives float t of row g
    of each matrix."""
    return np.array([[smem[addrs[8 * i + lane // 4] + lane % 4]
                      for i in range(4)] for lane in range(32)])


def mma_m16n8k8(a, b):
    """``mma.sync.m16n8k8`` (TF32) on per-lane fragments, exactly: A
    a[lane][0..3] at (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
    B b[lane][0..1] at (k t, n g), (k t + 4, n g); the accumulator
    c[lane][0..3] at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e, (r, k) in enumerate(((g, t), (g + 8, t), (g, t + 4),
                                    (g + 8, t + 4))):
            am[r, k] = a[lane][e]
        bm[t, g], bm[t + 4, g] = b[lane]
    return from_acc(am @ bm)


def from_acc(m):
    """A 16 x 8 matrix as accumulator fragments, per lane."""
    return np.array([[m[g, 2 * t], m[g, 2 * t + 1], m[g + 8, 2 * t],
                      m[g + 8, 2 * t + 1]]
                     for g, t in (divmod(lane, 4) for lane in range(32))])


def to_mat(c):
    """Accumulator fragments, per lane, as the 16 x 8 matrix."""
    m = np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        m[g, 2 * t], m[g, 2 * t + 1] = c[lane][0], c[lane][1]
        m[g + 8, 2 * t], m[g + 8, 2 * t + 1] = c[lane][2], c[lane][3]
    return m


@pytest.mark.parametrize("d", [16, 32])
def test_mma_f32_fragments_give_s_and_p_v(d):
    """The f32 mma kernel's index maps (csrc/flash_attention.cu:
    flash_mma_f32_kernel), on one strip and one 32-key tile of shared
    rows of D + 4 floats, with integer values so every sum is exact:
    ldmatrix at the kernel's row addresses gives q's A fragment and K's B
    fragments as stored, whose products are S = Q K^T; S's accumulator
    taken as P's A fragment a = (c0, c2, c1, c3), with V read at keys 2t
    and 2t + 1 of each 8-key step, gives exactly P V; and the reads fall
    in distinct banks (ldmatrix rows in distinct 16-byte groups, the
    scalar V reads in 32 distinct 4-byte banks)."""
    rng = np.random.default_rng(d)
    rs, skew = d + 4, 4              # the kernel's kRS and head skew
    qm = rng.integers(-4, 5, (16, d)).astype(np.float64)
    km = rng.integers(-4, 5, (32, d)).astype(np.float64)
    vm = rng.integers(-4, 5, (32, d)).astype(np.float64)
    q_at, k_at = skew, 16 * rs + 2 * skew   # a second head's strip, and a
    v_at = k_at + 32 * rs + skew            # second KV head's K and V tile
    smem = np.zeros(v_at + 32 * rs)
    for base, m in ((q_at, qm), (k_at, km), (v_at, vm)):
        for r in range(len(m)):
            smem[base + r * rs:base + r * rs + d] = m[r]

    s = np.zeros((4, 32, 4))             # 4 n8 tiles of keys
    for kk in range(d // 8):
        qa = [q_at + ((lane & 7) + ((lane >> 3) & 1) * 8) * rs + kk * 8
              + (lane >> 4) * 4 for lane in range(32)]
        a = ldmatrix_x4(smem, qa)
        assert all(a[ln].tolist() == [
            qm[ln // 4, 8 * kk + ln % 4], qm[ln // 4 + 8, 8 * kk + ln % 4],
            qm[ln // 4, 8 * kk + ln % 4 + 4],
            qm[ln // 4 + 8, 8 * kk + ln % 4 + 4]] for ln in range(32))
        for np_ in range(2):
            ka = [k_at + (np_ * 16 + (lane & 7) + (lane >> 4) * 8) * rs
                  + kk * 8 + ((lane >> 3) & 1) * 4 for lane in range(32)]
            kb = ldmatrix_x4(smem, ka)
            for n in range(2):
                s[2 * np_ + n] += mma_m16n8k8(a, kb[:, 2 * n:2 * n + 2])
            for addrs in (qa, ka):
                for i in range(4):
                    rows = [addrs[8 * i + r] for r in range(8)]
                    assert all(x % 4 == 0 for x in rows)   # 16-byte rows
                    assert len({x // 4 % 8 for x in rows}) == 8
    st = np.concatenate([to_mat(c) for c in s], axis=1)
    np.testing.assert_array_equal(st, qm @ km.T)

    pm = rng.integers(0, 4, (16, 32)).astype(np.float64)
    p = [from_acc(pm[:, 8 * kk:8 * kk + 8]) for kk in range(4)]
    # the index maps: a[e] holds what c[(0, 2, 1, 3)[e]] holds when k
    # index t is key 2t and t + 4 is key 2t + 1
    for lane in range(32):
        g, t = divmod(lane, 4)
        a_pos = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
        c_pos = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                 (g + 8, 2 * t + 1)]
        key = {t: 2 * t, t + 4: 2 * t + 1}
        for e, src in enumerate((0, 2, 1, 3)):
            assert (a_pos[e][0], key[a_pos[e][1]]) == c_pos[src]
    o = np.zeros((d // 8, 32, 4))
    for kk in range(4):
        a = p[kk][:, [0, 2, 1, 3]]
        # V[2t][g] and V[2t + 1][g] of the step's keys, by the kernel's
        # address v0 = (8 kk + 2t) rs + g, + 8 dn, + rs for key 2t + 1
        v0 = [v_at + (8 * kk + 2 * (lane % 4)) * rs + lane // 4
              for lane in range(32)]
        for dn in range(d // 8):
            b = np.array([[smem[x + 8 * dn], smem[x + rs + 8 * dn]]
                          for x in v0])
            o[dn] += mma_m16n8k8(a, b)
            for off in (0, rs):
                assert len({(x + 8 * dn + off) % 32 for x in v0}) == 32
    # one 16 x 8 x 8 step, then the whole tile
    np.testing.assert_array_equal(
        to_mat(mma_m16n8k8(p[0][:, [0, 2, 1, 3]], np.array(
            [[vm[2 * (ln % 4), ln // 4], vm[2 * (ln % 4) + 1, ln // 4]]
             for ln in range(32)]))), pm[:, :8] @ vm[:8, :8])
    np.testing.assert_array_equal(
        np.concatenate([to_mat(c) for c in o], axis=1), pm @ vm)
