"""The f32 flash backward's tensor-core arithmetic and layouts, on the CPU.

``flash_bwd_dkdv_wgmma_f32_kernel`` and ``flash_bwd_dq_wgmma_f32_kernel``
(``csrc/flash_attention_bwd.cu``) take every product as three TF32
products of hi and lo parts (A_lo B_hi + A_hi B_lo + A_hi B_hi; hi = x
rounded to TF32, to nearest with ties away from zero, lo = x - hi, of
which wgmma reads the top 19 bits: modelled here as rounded to TF32), with
P and dS formed in f32 and split the same way. They run only on the card (``chip_smoke.py``
holds them against the plain backward there); here their arithmetic is
emulated with TF32 rounding by bit arithmetic and held against the plain
backward (``ref.ref_flash_attention_bwd``) within
``chip_smoke.BWD_TOL[f32]`` and against ``jax.vjp`` of the JAX package's
``_chunked_attention``, where one TF32 product does not hold. The index
maps the kernels rely on are checked exactly: the transposed tiles' 8-group
order (each accumulator column of P or dS lands in the A-fragment slot
that meets its row of the transposed B operand), the producer's
shared-memory writes (free of bank conflicts), the k8 steps' descriptor
addresses in the 128-byte swizzle, and that every trip of the f32 plan
holds a visible pair (the kernels skip none).
"""
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
from test_torch_flash_bwd_plan import SHAPES, tiles_seen, within  # noqa: E402
from test_torch_flash_plan import tc_product  # noqa: E402

F32_TOL = chip_smoke.BWD_TOL[torch.float32]


def emulated_f32_bwd(q, k, v, do, lse, delta, products=3):
    """The f32 kernels' arithmetic on the host: S = q K^T and dP = dO V^T
    on TF32 operands (``products`` 3: the kernels' three products of hi
    and lo parts; 1: one product of the rounded operands), P =
    exp2(S D^-0.5 log2(e) - lse log2(e)) with 0 where masked, dS = P (dP -
    delta), then dV = P^T dO, dK = dS^T q and dQ = dS K the same way (P
    and dS split as the kernels split their fragments), each summed in
    f32; dK and dQ times D^-0.5 at the end."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qf, dof = (x.reshape(b, sq, kh, g, d) for x in (q, do))
    s = tc_product("bqkgd,bskd->bkgqs", qf, k, products)
    dp = tc_product("bqkgd,bskd->bkgqs", dof, v, products)
    mask = (torch.arange(sq)[:, None] + (sk - sq)) >= torch.arange(sk)[None]
    log2e = torch.tensor(1 / math.log(2), dtype=torch.float32)
    lse2 = lse.reshape(b, kh, g, sq, 1) * log2e
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - lse2), 0.0)
    ds = p * (dp - delta.reshape(b, kh, g, sq, 1))
    dv = tc_product("bkgqs,bqkgd->bskd", p, dof, products)
    dk = tc_product("bkgqs,bqkgd->bskd", ds, qf, products) * scale
    dq = tc_product("bkgqs,bskd->bqkgd", ds, k, products) * scale
    return dq.reshape(b, sq, h, d), dk, dv


def plain_and_emulated(b, sq, sk, h, kh, d, products=3, seed=None):
    q, k, v, do = (torch.as_tensor(x) for x in inputs(
        sq * 7 + sk + d if seed is None else seed, b, sq, sk, h, kh, d))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    delta = tref.ref_flash_bwd_delta(o, do)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    return want, emulated_f32_bwd(q, k, v, do, lse, delta, products)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kh", SHAPES)
def test_three_tf32_products_hold_the_plain_backward(b, sq, sk, h, kh, d):
    """Three TF32 products of split operands keep every product at f32
    precision: the kernels' arithmetic gives the plain backward's f32
    gradients within BWD_TOL[f32], and rows that see no key get exactly
    0."""
    want, got = plain_and_emulated(b, sq, sk, h, kh, d)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == torch.float32 and gt.shape == w.shape, name
        assert torch.isfinite(gt).all(), name
        assert within(gt, w, F32_TOL), name
    if sq > sk:
        assert (got[0][:, :sq - sk] == 0).all()


def test_one_tf32_product_does_not_hold_the_plain_backward():
    """Each product as one TF32 product of the rounded operands (2^-11 of
    each operand off) moves the gradients by more than BWD_TOL[f32] at a
    shape where three products hold them."""
    shape = (1, 257, 1000, 4, 4, 64)
    want, three = plain_and_emulated(*shape)
    assert all(within(g_, w, F32_TOL) for g_, w in zip(three, want))
    _, one = plain_and_emulated(*shape, products=1)
    assert not any(within(g_, w, F32_TOL) for g_, w in zip(one, want))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [33, 130])
def test_three_tf32_products_match_jax_vjp_of_chunked(s, d, g):
    """The kernels' arithmetic against JAX's f32 gradient of the scan its
    training differentiates, on the same inputs, within the backward
    tests' f32 tolerance."""
    kh = 2
    q, k, v, do = inputs(s * 17 + d + g, 1, s, s, kh * g, kh, d)
    _, vjp = jax.vjp(lambda a, b_, c: _chunked_attention(
        a, b_, c, True, 0, JAX_CHUNK, False, False),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = tref.ref_flash_attention(tq, tk, tv, return_lse=True)
    got = emulated_f32_bwd(tq, tk, tv, tdo, lse,
                           tref.ref_flash_bwd_delta(o, tdo))
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(gt.numpy() - w).max()
        assert err <= TOL[np.float32] * max(1.0, np.abs(w).max()), (name,
                                                                    err)


def perm8(t):
    """The kernels' slot of index t in its 8-group of a transposed tile."""
    return (t & ~7) | ((t & 1) << 2) | ((t & 7) >> 1)


@pytest.mark.parametrize("k", [16, 32])
def test_transposed_order_maps_accumulator_columns_to_fragment_slots(k):
    """P^T, dS^T (dkdv) and dS (dq) go from the accumulator fragment to
    TF32 A fragments with no register moved between lanes: register e of
    k8 step kk takes accumulator element 4 kk + 2 (e & 1) + (e >> 1), and
    the transposed B tile stores that element's column at the slot the
    A register meets, so sum_slot A[row, slot] B[slot, n] is sum_col
    X[row, col] Y[col, n]."""
    assert all(sorted(perm8(np.arange(8 * j, 8 * j + 8))) ==
               list(range(8 * j, 8 * j + 8)) for j in range(k // 8))
    for lane in range(32):
        used = set()
        for kk in range(k // 8):
            for e in range(4):
                i = 4 * kk + ((e & 1) << 1) + (e >> 1)
                used.add(i)
                # the accumulator's element i (wgmma's D fragment)
                acc_row = lane // 4 + 8 * ((i >> 1) & 1)
                acc_col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)
                # the TF32 A fragment's register e of step kk
                a_row = lane // 4 + 8 * (e & 1)
                a_slot = 8 * kk + (lane & 3) + 4 * (e >> 1)
                assert (acc_row, perm8(acc_col)) == (a_row, a_slot)
        assert used == set(range(k // 2))


def swz(rows, row, col):
    """csrc/hopper.cuh: swz, the byte offset of f32 (row, col) in a K-major
    tile of 32-column boxes, 128-byte swizzled."""
    return ((col >> 5) * rows * 128 + row * 128
            + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2))


def kstep(rows, col):
    """csrc/flash_attention_bwd.cu: kstep, where a k8 step at ``col``
    starts."""
    return (col >> 5) * rows * 128 + ((col & 31) >> 3) * 32


@pytest.mark.parametrize("rows", [16, 32, 64, 128])
def test_k8_steps_read_the_swizzled_tiles(rows):
    """A K-major operand's descriptor at tile + kstep(col) (the 128-byte
    swizzle: 8-row groups 1024 bytes apart, the address's bits 4-6 XOR
    its bits 7-9) reads element (row, col + c) where the producer and TMA
    put it, swz(row, col + c), for every row and k8 step."""
    for col in range(0, 4 * 32, 8):
        for row in range(rows):
            for c in range(8):
                addr = (kstep(rows, col) + (row // 8) * 1024
                        + (row % 8) * 128 + c * 4)
                addr ^= ((addr >> 7) & 7) << 4
                assert addr == swz(rows, row, col + c)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("k_rows", [16, 32])
def test_producer_writes_are_free_of_bank_conflicts(k_rows, d):
    """split_tile (csrc/flash_attention_bwd.cu) run by one warp: each
    float4 read and write (8-lane phases of 128 bytes) touches 8 distinct
    16-byte bank groups, and each scalar transposed write 32 distinct
    banks (th_col 0 and k_rows: q^T beside dO^T, K^T hi beside lo)."""
    for warp in range(4):
        for it in range(k_rows * d // 4 // 128):
            f = np.arange(32) + 32 * warp + 128 * it
            row, d0 = f % k_rows, 4 * (f // k_rows)
            off = np.array([swz(k_rows, r, c) for r, c in zip(row, d0)])
            for phase in range(4):
                chunks = (off[8 * phase:8 * phase + 8] // 16) % 8
                assert len(set(chunks.tolist())) == 8
            for th_col in (0, k_rows):
                for c in range(4):
                    t_off = np.array([swz(d, x + c, th_col + perm8(r))
                                      for r, x in zip(row, d0)])
                    assert len(set(((t_off // 4) % 32).tolist())) == 32


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("b,sq,sk", [(1, 1, 1), (2, 65, 65), (1, 127, 300),
                                     (1, 300, 70), (1, 257, 1000)])
def test_f32_plan_trips_each_hold_a_visible_pair(b, sq, sk, g, d):
    """The f32 kernels skip no trip: every (query tile, key tile) that
    the f32 plan's dkdv block (from first_q_tile, bq rows a trip, 64
    keys) and dq block (64 rows, dq_trips of dq_bk keys) visit holds a
    visible pair, and they visit all of them."""
    kh = 2
    q = torch.empty((b, sq, kh * g, d))
    k = torch.empty((b, sk, kh, d))
    p = fa.bwd_plan(q, k, k)
    assert p.design == "wgmma_f32" and (p.bq, p.bk, p.dq_bq, p.dq_bk) == (
        *fa.BWD_WGMMA_F32_TILES[d][0], *fa.BWD_WGMMA_F32_TILES[d][1])
    dkdv = {(qt, kt) for kt in range(p.n_k_tiles)
            for qt in range(p.first_q_tile[kt], p.n_q_tiles)}
    dq = {(qt, kt) for qt in range(p.dq_q_tiles)
          for kt in range(p.dq_trips[qt])}
    assert dkdv == tiles_seen(sq, sk, p.bq, p.bk)
    assert dq == tiles_seen(sq, sk, p.dq_bq, p.dq_bk)
