"""The flash backward's tensor-core plan and arithmetic, on the CPU.

``repro_torch.kernels.flash_attention.bwd_plan`` decides what the
backward kernels are told from the host: the design a dtype takes
(``wgmma`` for bf16, ``wgmma_f32`` for f32), the tiles and block order of the
dkdv and dq kernels, their causal trips, and the TMA maps of q, k, v and
dO with the operands that have to be copied first. It is a pure function
of shapes, strides and addresses, so it is tested here against the
kernels' own mapping of ``blockIdx`` (written out below as the kernels
compute it). The kernels run only on the card (``chip_smoke.py``); their
arithmetic is emulated here instead: bf16 q, k, v and dO, f32 logits,
P^T and dS^T in f32 entering the products as two bf16 parts (hi + lo),
each part's product summed in f32, must hold the plain backward
(``ref.ref_flash_attention_bwd``) within ``chip_smoke.BWD_TOL[bf16]``
and ``jax.vjp`` of the JAX package's ``_chunked_attention`` within the
backward tests' tolerance.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.models.attention import _chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_flash_backward import JAX_CHUNK, TOL, inputs  # noqa: E402

BF16 = torch.bfloat16
BWD_TOL = chip_smoke.BWD_TOL

# (B, Sq, Sk, H, K): ragged tiles, Sq < Sk, Sq > Sk (rows that see no
# key), one row, several blocks each way
SHAPES = [(2, 1, 1, 2, 2), (1, 64, 64, 4, 4), (2, 65, 65, 4, 1),
          (1, 127, 300, 8, 2), (2, 129, 129, 2, 2), (1, 300, 70, 4, 1),
          (1, 200, 201, 8, 8), (1, 257, 1000, 4, 4)]


def tiles_seen(sq, sk, bq, bk):
    """The (query tile, key tile) pairs of bq x bk tiles that hold a
    visible (query, key) pair: query i sees key j <= i + sk - sq."""
    vis = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + (sk - sq)
    per = np.add.reduceat(np.add.reduceat(
        vis.astype(np.int64), np.arange(0, sq, bq), axis=0),
        np.arange(0, sk, bk), axis=1)
    return set(zip(*(x.tolist() for x in np.nonzero(per))))


def dkdv_visits(p, b, h, kh):
    """(batch, head, query tile, key tile) of every trip of the dkdv
    kernel, block by block as it maps ``blockIdx.x`` (key tile, KV head,
    batch; then the G heads of the KV head, each over the query tiles from
    ``first_q_tile``), and each block's trip count."""
    g, per = h // kh, kh * b
    visits, trips = [], []
    for x in range(p.dkdv_blocks):
        kt, kvh, bb = x // per, x % per % kh, x % per // kh
        n = 0
        for gi in range(g):
            for qt in range(p.first_q_tile[kt], p.n_q_tiles):
                visits.append((bb, kvh * g + gi, qt, kt))
                n += 1
        trips.append(n)
    return visits, trips


def dq_visits(p, b, h):
    """The same for the dq kernel: blocks (query tile, head, batch), the
    last query tile first, each over key tiles 0 .. dq_trips - 1."""
    per = h * b
    visits, trips = [], []
    for x in range(p.dq_blocks):
        qt, hh, bb = p.dq_q_tiles - 1 - x // per, x % per % h, x % per // h
        visits += [(bb, hh, qt, kt) for kt in range(p.dq_trips[qt])]
        trips.append(p.dq_trips[qt])
    return visits, trips


@pytest.mark.parametrize("dtype", [BF16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("b,sq,sk", [(2, 1, 1), (1, 64, 64), (2, 65, 65),
                                     (1, 127, 300), (1, 300, 70),
                                     (1, 257, 1000), (2, 129, 257)])
def test_bwd_plan_visits_every_causal_tile_pair_once(b, sq, sk, g, d, dtype):
    kh = 2
    h = kh * g
    q = torch.empty((b, sq, h, d), dtype=dtype)
    k = torch.empty((b, sk, kh, d), dtype=dtype)
    p = fa.bwd_plan(q, k, k)
    wg = dtype == BF16
    assert p.design == ("wgmma" if wg else "wgmma_f32")
    (bq, bk), (dq_bq, dq_bk) = (fa.BWD_WGMMA_TILES if wg else
                                fa.BWD_WGMMA_F32_TILES)[d]
    assert (p.bq, p.bk, p.dq_bq, p.dq_bk) == (bq, bk, dq_bq, dq_bk)
    if wg:   # 64 keys a consumer warpgroup: two at D 64, one at D 128
        assert bk == (128 if d == 64 else 64) and (bq, dq_bq, dq_bk) == (
            64, 128, 64)
    else:    # 64 keys a block; 32-row / 32-key trips at D 64, 16 at 128
        assert (bk, dq_bq) == (64, 64) and bq == dq_bk == 2048 // d
    assert (p.n_q_tiles, p.n_k_tiles, p.dq_q_tiles) == (
        -(-sq // bq), -(-sk // bk), -(-sq // dq_bq))
    assert p.dkdv_blocks == p.n_k_tiles * kh * b
    assert p.dq_blocks == p.dq_q_tiles * h * b
    for visits, trips, seen in (
            (*dkdv_visits(p, b, h, kh), tiles_seen(sq, sk, bq, bk)),
            (*dq_visits(p, b, h), tiles_seen(sq, sk, dq_bq, dq_bk))):
        # every visible tile pair of every (batch, head) exactly once, and
        # nothing else
        assert len(visits) == len(set(visits))
        assert set(visits) == {(bb, hh, t, c) for bb in range(b)
                               for hh in range(h) for t, c in seen}
        # the heaviest blocks first
        assert trips == sorted(trips, reverse=True)


def test_bwd_plan_maps_and_copies():
    b, s, h, kh, d = 2, 100, 8, 2, 64
    q = torch.zeros((b, s, h, d), dtype=BF16)
    k = torch.zeros((b, s, kh, d), dtype=BF16)
    p = fa.bwd_plan(q, k, k, q)
    assert p.copies == () and len(p.maps) == 8
    es = 2
    rows = [p.bq, p.bk, p.bk, p.bq, p.dq_bq, p.dq_bk, p.dq_bk, p.dq_bq]
    for m, t, r in zip(p.maps, (q, k, k, q) * 2, rows):
        assert m.dims == (d, t.shape[2], t.shape[1], b)
        assert m.strides == tuple(st * es for st in (t.stride(2), t.stride(1),
                                                     t.stride(0)))
        assert m.box == (fa.BOX_COLS, 1, r, 1)
    # the launcher's args: shapes, tile counts, strides, design, dq's
    # query tiles, then the eight maps
    args = list(fa._bwd_args(p, q, k, k, q, q))
    assert len(args) == 26 + 8 * 11
    assert args[:9] == [b, s, s, h, kh, d, 1, p.n_q_tiles, p.n_k_tiles]
    assert args[24:26] == [fa.BWD_DESIGNS.index("wgmma"), p.dq_q_tiles]
    assert args[26:37] == p.maps[0].packed()
    # a transposed q (heads outermost) is read through its strides
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    pt = fa.bwd_plan(qt, k, k, q)
    assert pt.copies == () and pt.maps[0].strides == (s * d * es, d * es,
                                                      h * s * d * es)
    # what TMA cannot read: a k 2 bytes past a 16-byte boundary, q's heads
    # padded by 2 elements (a 132-byte head stride), the zero-stride dO of
    # a scalar loss, a dO whose head dim is not contiguous
    mis = torch.zeros(k.numel() + 1, dtype=BF16)[1:].view(k.shape)
    padded = torch.zeros((b, s, h, d + 2), dtype=BF16)[..., :d]
    zero = torch.ones((), dtype=BF16).expand(q.shape)
    cols = torch.zeros((b, s, d, h), dtype=BF16).transpose(2, 3)
    assert cols.shape == q.shape and cols.stride(-1) == h
    for args_, want in (((q, mis, k, q), ("k",)), ((padded, k, k, q), ("q",)),
                        ((q, k, mis, zero), ("v", "do")),
                        ((q, k, k, cols), ("do",))):
        pc = fa.bwd_plan(*args_)
        assert pc.copies == want and pc.maps is None
        *ready, pr = fa.bwd_ready(*args_)
        assert pr.copies == () and len(pr.maps) == 8
        for n, t, r in zip(fa.BWD_OPERANDS, args_, ready):
            assert torch.equal(t, r)
            assert (r.data_ptr() != t.data_ptr()) == (n in want)
    # f32 takes the TF32 tensor-core kernels: maps of 32-column boxes
    # (128 bytes) over the f32 tiles
    p32 = fa.bwd_plan(q.float(), k.float(), k.float(), q.float())
    assert p32.design == "wgmma_f32" and p32.copies == ()
    assert (p32.bq, p32.bk, p32.dq_bq, p32.dq_bk) == (32, 64, 64, 32)
    rows = [32, 64, 64, 32, 64, 32, 32, 64]
    for m, t, r in zip(p32.maps, (q, k, k, q) * 2, rows):
        assert m.box == (32, 1, r, 1) and m.strides == tuple(
            st * 4 for st in (t.stride(2), t.stride(1), t.stride(0)))
    mis32 = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    assert fa.bwd_plan(q.float(), mis32, k.float()).copies == ("k",)
    assert list(fa._bwd_args(p32, *(t.float() for t in (q, k, k, q, q))))[
        24:26] == [0, p32.dq_q_tiles]
    # every forward head dim has a backward; a head dim with no design
    # has neither
    with pytest.raises(ValueError, match="built for D"):
        fa.bwd_plan(*(torch.zeros((1, 4, 2, 96), dtype=BF16),) * 3)


def split2(x):
    """x (f32) as the kernels' two bf16 parts: hi = bf16(x), lo =
    bf16(x - hi), as f32."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def emulated_wgmma_bwd(q, k, v, do, lse, delta, parts=split2):
    """The wgmma kernels' arithmetic on the host: S and dP of the bf16
    inputs in f32 (each product exact), P = exp2(S D^-0.5 log2(e) - lse
    log2(e)) with 0 where masked, dS = P (dP - delta), each entering its
    products with dO, q and K as ``parts``, each part's product summed in
    f32; dK and dQ times D^-0.5 at the end; outputs rounded once to bf16."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale, log2e = d ** -0.5, 1 / math.log(2)

    def heads(t):   # (B, S, H, D) -> (B, K, G, S, D) f32
        return t.float().reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)

    qf, dof = heads(q), heads(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    mask = (torch.arange(sq)[:, None] + (sk - sq)) >= torch.arange(sk)[None]
    lse2 = lse.reshape(b, kh, g, sq, 1) * torch.tensor(log2e)
    p = torch.where(mask, torch.exp2(s * torch.tensor(scale * log2e) - lse2),
                    0.0)
    ds = p * (dp - delta.reshape(b, kh, g, sq, 1))
    dv = sum(x.transpose(-1, -2) @ dof for x in parts(p)).sum(2)
    dk = sum(x.transpose(-1, -2) @ qf for x in parts(ds)).sum(2) * scale
    dq = sum(x @ kf for x in parts(ds)) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(BF16),
            dk.permute(0, 2, 1, 3).to(BF16), dv.permute(0, 2, 1, 3).to(BF16))


def within(got, want, tol) -> bool:
    """chip_smoke's check: |got - want| <= atol + rtol |want|."""
    return bool(((got.float() - want.float()).abs()
                 <= tol[0] + tol[1] * want.float().abs()).all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kh", SHAPES)
def test_two_part_products_hold_the_plain_backward(b, sq, sk, h, kh, d):
    """The split of P and dS into bf16 hi + lo keeps every product at f32
    precision: the kernels' arithmetic gives the plain backward's bf16
    gradients within BWD_TOL[bf16] (one bf16 ulp), and rows that see no
    key get exactly 0."""
    q, k, v, do = (torch.as_tensor(x).to(BF16)
                   for x in inputs(sq * 7 + sk + d, b, sq, sk, h, kh, d))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    delta = tref.ref_flash_bwd_delta(o, do)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    got = emulated_wgmma_bwd(q, k, v, do, lse, delta)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == BF16 and gt.shape == w.shape, name
        assert torch.isfinite(gt.float()).all(), name
        assert within(gt, w, BWD_TOL[BF16]), name
    if sq > sk:
        assert (got[0][:, :sq - sk] == 0).all()


def test_one_bf16_part_does_not_hold_the_plain_backward():
    """P and dS rounded to bf16 once (one part, as FlashAttention-2/3 take
    them) move gradients by more than BWD_TOL[bf16] from the plain
    backward's at a shape where the two parts hold it."""
    b, sq, sk, h, kh, d = 1, 257, 1000, 4, 4, 64
    q, k, v, do = (torch.as_tensor(x).to(BF16)
                   for x in inputs(sq * 7 + sk + d, b, sq, sk, h, kh, d))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    delta = tref.ref_flash_bwd_delta(o, do)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    one = emulated_wgmma_bwd(q, k, v, do, lse, delta,
                             parts=lambda x: (x.to(BF16).float(),))
    assert not all(within(g_, w, BWD_TOL[BF16]) for g_, w in zip(one, want))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [33, 130])
def test_two_part_products_match_jax_vjp_of_chunked(s, d, g):
    """The kernels' arithmetic against JAX's gradient of the scan its
    training differentiates, on the same bf16 inputs."""
    kh = 2
    q, k, v, do = inputs(s * 13 + d + g, 1, s, s, kh * g, kh, d)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: _chunked_attention(
        a, b_, c, True, 0, JAX_CHUNK, False, False), jq, jk, jv)
    want = [np.asarray(x, np.float32) for x in vjp(jdo)]
    tq, tk, tv, tdo = (torch.as_tensor(np.asarray(x, np.float32)).to(BF16)
                       for x in (jq, jk, jv, jdo))
    o, lse = tref.ref_flash_attention(tq, tk, tv, return_lse=True)
    got = emulated_wgmma_bwd(tq, tk, tv, tdo, lse,
                             tref.ref_flash_bwd_delta(o, tdo))
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(gt.float().numpy() - w).max()
        assert err <= TOL[jnp.bfloat16] * max(1.0, np.abs(w).max()), (name,
                                                                      err)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_backward_wrappers_count_by_design(dtype):
    """On CPU tensors the wrappers take the plain backward and count no
    launch; each wrapper has a count for both designs."""
    q, k, v, do = (torch.as_tensor(x).to(dtype)
                   for x in inputs(1, 1, 20, 20, 4, 2, 64))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    before = [(w.launches, dict(w.by_design))
              for w in (fa.flash_bwd_dkdv, fa.flash_bwd_dq)]
    delta = fa.flash_bwd_delta(o, do)
    fa.flash_bwd_dkdv(q, k, v, do, lse, delta)
    fa.flash_bwd_dq(q, k, v, do, lse, delta)
    after = [(w.launches, dict(w.by_design))
             for w in (fa.flash_bwd_dkdv, fa.flash_bwd_dq)]
    assert before == after
    assert all(set(bd) == set(fa.BWD_DESIGNS) for _, bd in after)


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_d112_backward_takes_d128_tiles_over_112_columns(dtype):
    """D 112 (kimi-k2) on the wgmma backward: D 128's tiles and trips,
    TMA maps over the tensors' 112 columns (the kernels' boxes past column
    112 come back zero-filled), and the launchers' plan naming D 112."""
    b, s, h, kh = 1, 300, 16, 2
    q = torch.zeros((b, s, h, 112), dtype=dtype)
    k = torch.zeros((b, s, kh, 112), dtype=dtype)
    p, p128 = fa.bwd_plan(q, k, k), fa.bwd_plan(
        torch.zeros((b, s, h, 128), dtype=dtype),
        *(torch.zeros((b, s, kh, 128), dtype=dtype),) * 2)
    assert p.design == p128.design == fa.design(dtype, 112)
    tiles = (fa.BWD_WGMMA_TILES if dtype == BF16 else
             fa.BWD_WGMMA_F32_TILES)
    assert tiles[112] == tiles[128]
    for f in ("n_q_tiles", "n_k_tiles", "dkdv_blocks", "dq_blocks",
              "first_q_tile", "dq_trips", "bq", "bk", "dq_bq", "dq_bk"):
        assert getattr(p, f) == getattr(p128, f), f
    es = q.element_size()
    rows = [p.bq, p.bk, p.bk, p.bq, p.dq_bq, p.dq_bk, p.dq_bk, p.dq_bq]
    for m, t, r in zip(p.maps, (q, k, k, q) * 2, rows):
        assert m.dims == (112, t.shape[2], s, b)
        assert m.box == (fa.SWIZZLE_BYTES // es, 1, r, 1)
        assert m.strides == tuple(st * es for st in (t.stride(2),
                                                     t.stride(1),
                                                     t.stride(0)))
    args = list(fa._bwd_args(p, q, k, k, q, q))
    assert len(args) == 114 and args[5] == 112
    assert fa.BWD_DESIGNS[args[24]] == p.design
    # the delta kernel: 16 lanes a row over D 112's 28 pieces
    assert p.delta_blocks == -(-b * h * s // (256 // 16))


@pytest.mark.parametrize("d", [8, 16, 32, 64, 112, 128])
def test_delta_lanes_cover_each_row_once_inside_a_warp(d):
    lanes = fa.delta_lanes(d)
    assert lanes & (lanes - 1) == 0 and lanes <= 32 and 32 % lanes == 0
    assert lanes <= d // 4 < 2 * lanes or lanes == 32
    pieces = sorted(c for lane in range(lanes)
                    for c in range(lane, d // 4, lanes))
    assert pieces == list(range(d // 4))


def mma_dkdv_visits(p, sq, sk, h, kh, b):
    """(batch, query head, 32-row query tile, 16-key strip) of every trip
    a warp of the mma dkdv kernel computes, as it maps ``blockIdx.x`` and
    its warps (``mma_bwd_units``): the block's trips are the G query heads
    of its KV heads over the query tiles from the first that sees its
    first key, and a warp skips a trip where every key of its strip
    follows every query of the tile (or lies past Sk)."""
    dk_p, _ = p.mma
    g, offset = h // kh, sk - sq
    n_q = -(-sq // 32)
    visits, trips = [], []
    for x, warps in enumerate(fa.mma_bwd_units(dk_p, b)):
        per = dk_p.head_groups * b
        k_blk = x // per * dk_p.strips_per_block * 16
        first = max(k_blk - offset, 0) // 32
        trips.append(g * (n_q - first))
        for gi in range(g):
            for qt in range(first, n_q):
                q_last = min(qt * 32 + 32, sq) - 1
                for unit in warps:
                    if unit is None:
                        continue
                    strip, kvh, bb = unit
                    if strip * 16 < sk and strip * 16 <= offset + q_last:
                        visits.append((bb, kvh * g + gi, qt, strip))
    return visits, trips


def mma_dq_visits(p, sq, sk, b):
    """The same for the mma dq kernel: the forward's units
    (``mma_units``), each warp over the key tiles its strip sees."""
    _, dq_p = p.mma
    visits = []
    for warps in fa.mma_units(dq_p, b):
        for unit in warps:
            if unit is None:
                continue
            strip, hh, bb = unit
            n = fa.trip_count(strip, sq, sk, 16, 32)
            visits += [(bb, hh, strip, kt) for kt in range(n)]
    return visits


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("b,sq,sk,h,kh", [
    (2, 1, 1, 2, 2), (1, 33, 33, 8, 8), (4, 32, 32, 8, 8), (2, 65, 65, 7, 1),
    (1, 127, 300, 8, 2), (1, 300, 70, 4, 1), (2, 129, 129, 14, 2),
    (1, 16, 1000, 4, 4)])
def test_mma_bwd_plan_visits_every_causal_pair_once(b, sq, sk, h, kh, d,
                                                     dtype):
    """The mma backward's packing (``mma_bwd_plan``): dkdv packs 16-key
    strips of several KV heads a block (every (strip, KV head, batch) one
    warp's), dq the forward's 16-row query strips; between them every
    (query tile, key strip) and (query strip, key tile) pair that holds a
    visible (query, key) pair is computed once for every head, the
    heaviest dkdv blocks first; and their shared memory fits a block."""
    q = torch.zeros((b, sq, h, d), dtype=dtype)
    k = torch.zeros((b, sk, kh, d), dtype=dtype)
    p = fa.bwd_plan(q, k, k)
    es = q.element_size()
    dk_p, dq_p = p.mma
    assert p.design == fa.design(dtype, d) and p.maps is None
    assert (p.bq, p.bk, p.dq_bq, p.dq_bk) == (32, 16, 16, 32)
    assert dq_p == dataclasses.replace(
        fa.mma_plan(sq, sk, h, kh, b, d, es), smem=dq_p.smem)
    units = [u for w in fa.mma_bwd_units(dk_p, b) for u in w if u]
    assert sorted(units) == sorted(
        (s, kvh, bb) for s in range(-(-sk // 16)) for kvh in range(kh)
        for bb in range(b))
    assert dk_p.warps <= fa.MMA_WARPS and kh % dk_p.heads_per_block == 0
    for mp in (dk_p, dq_p):
        assert mp.smem <= 227 * 1024
    visits, trips = mma_dkdv_visits(p, sq, sk, h, kh, b)
    want = {(bb, hh, t, c) for bb in range(b) for hh in range(h)
            for t, c in tiles_seen(sq, sk, 32, 16)}
    assert len(visits) == len(set(visits)) and set(visits) == want
    assert trips == sorted(trips, reverse=True)
    assert dk_p.stages == (2 if h // kh * -(-sq // 32) > 1 else 1)
    visits = mma_dq_visits(p, sq, sk, b)
    want = {(bb, hh, t, c) for bb in range(b) for hh in range(h)
            for t, c in tiles_seen(sq, sk, 16, 32)}
    assert len(visits) == len(set(visits)) and set(visits) == want
    # the launchers' plan: no maps, the two packings appended
    args = list(fa._bwd_args(p, q, k, k, q, q))
    assert args[26:114] == [0] * 88 and args[114:] == [
        dk_p.strips_per_block, dk_p.heads_per_block, dk_p.stages,
        dk_p.blocks, dk_p.smem, dq_p.strips_per_block, dq_p.heads_per_block,
        dq_p.kv_heads_per_block, dq_p.stages, dq_p.blocks, dq_p.smem]


def test_mma_bwd_packs_the_encoder_shape_into_full_blocks():
    """At the Meta-pipe encoder's S 32 with 8 heads over 8 KV heads: dkdv
    2 key strips x 4 KV heads, dq 2 query strips x 4 heads, 8 warps each,
    one stage (one trip); a zero-stride dO (a scalar loss's) and a q with
    rows that are no multiple of 16 bytes are copied, a transposed q is
    read as it lies."""
    q = torch.zeros((4096, 32, 8, 32), dtype=BF16)
    p = fa.bwd_plan(q, q, q)
    dk_p, dq_p = p.mma
    assert (dk_p.strips_per_block, dk_p.heads_per_block, dk_p.stages) == (
        2, 4, 1)
    assert (dq_p.strips_per_block, dq_p.heads_per_block) == (2, 4)
    assert dk_p.blocks == dq_p.blocks == 4096 * 2
    ones = torch.ones(()).to(BF16).expand(q.shape)
    assert fa.bwd_plan(q, q, q, ones).copies == ("do",)
    padded = torch.zeros((4096, 32, 8, 33), dtype=BF16)[..., :32]
    assert fa.bwd_plan(padded, q, q).copies == ("q",)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert fa.bwd_plan(qt, q, q).copies == ()
