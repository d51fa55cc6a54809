"""The flash attention backward's plain version and host plan, on the CPU.

``ref.ref_flash_attention_bwd`` (the plain version of the three kernels
of ``csrc/flash_attention_bwd.cu``) is held against ``jax.vjp`` of the JAX
package's ``_chunked_attention`` (the scan its training differentiates,
with a chunk shorter than S so that it runs several chunks) on the same
numpy inputs, and against f64 autograd through ``ref.ref_attention``.
``FlashAttentionFn`` (what ``flash_attention`` takes when an input needs
grad) must hand q, k and v the plain backward's gradients on CPU tensors.
The kernels themselves are held against the plain version on the card by
``chip_smoke.py``'s ``kernel_edges_train`` phase, at every head dim (D 8
to 128: the ``mma`` designs' backward and the ``wgmma`` designs', D 112
in D 128's tiles).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

JAX_CHUNK = 32   # key chunk of the JAX scan: several chunks at S 33 / 130
# max |port - jax| over max(1, max |jax|) per gradient. f32: the same
# arithmetic, summed in another order. bf16: both round an f32 gradient
# to bf16 (one ulp, 2^-8 of the value) and the port's delta reads the
# bf16 output where JAX's autodiff has the f32 one
TOL = {np.float32: 2e-6, jnp.bfloat16: 2 ** -6}
F64_TOL = (1e-6, 1e-5)   # f32 plain backward against f64: atol, rtol


def inputs(seed, b, sq, sk, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32),
            rng.normal(size=(b, sk, kh, d)).astype(np.float32),
            rng.normal(size=(b, sq, h, d)).astype(np.float32))


def port_grads(q, k, v, do, dtype=torch.float32):
    q, k, v, do = (torch.as_tensor(x).to(dtype) for x in (q, k, v, do))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    return tref.ref_flash_attention_bwd(q, k, v, o, lse, do)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 33, 130])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 112])
def test_plain_backward_matches_jax_vjp_of_chunked(d, g, s, dtype):
    kh = 2
    q, k, v, do = inputs(s * 31 + d + g, 1, s, s, kh * g, kh, d)
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: _chunked_attention(
        a, b, c, True, 0, JAX_CHUNK, False, False), jq, jk, jv)
    want = [np.asarray(x, np.float32) for x in vjp(jdo)]
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = port_grads(*(np.asarray(x, np.float32)
                       for x in (jq, jk, jv, jdo)), tdt)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == tdt and tuple(gt.shape) == w.shape, name
        err = np.abs(gt.float().numpy() - w).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(w).max()), (name, err)


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [
    (2, 33, 33, 4, 1, 16),      # G 4
    (1, 130, 130, 4, 4, 64),    # several tiles each way
    (1, 1, 1, 2, 1, 64),
    (2, 20, 70, 8, 2, 32),      # Sq < Sk
    (1, 129, 200, 4, 2, 128),   # Sq < Sk, ragged tiles
])
def test_plain_backward_matches_f64_autograd(b, sq, sk, h, kh, d):
    q, k, v, do = inputs(sq + sk + d, b, sq, sk, h, kh, d)
    ts = [torch.as_tensor(x, dtype=torch.float64).requires_grad_()
          for x in (q, k, v)]
    tref.ref_attention(*ts).backward(torch.as_tensor(do, dtype=torch.float64))
    got = port_grads(q, k, v, do)
    for name, gt, t in zip(("dq", "dk", "dv"), got, ts):
        w = t.grad
        bound = F64_TOL[0] + F64_TOL[1] * w.abs()
        assert ((gt.double() - w).abs() <= bound).all(), name


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [
    (1, 130, 130, 4, 2, 64), (2, 40, 100, 2, 1, 16), (1, 50, 20, 4, 4, 64)])
def test_lse_matches_masked_logsumexp(b, sq, sk, h, kh, d):
    q, k, v, _ = inputs(7, b, sq, sk, h, kh, d)
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    o, lse = tref.ref_flash_attention(qt, kt, vt, bq=32, bk=32,
                                      return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert torch.equal(o, tref.ref_flash_attention(qt, kt, vt, bq=32, bk=32))
    g = h // kh
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          (qt * d ** -0.5).reshape(b, sq, kh, g, d), kt)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    logits = logits.masked_fill(~(qpos >= torch.arange(sk)[None, :]),
                                float("-inf"))
    want = torch.logsumexp(logits, dim=-1).reshape(b, h, sq)
    seen = torch.isfinite(want)
    assert torch.allclose(lse[seen], want[seen], atol=1e-5, rtol=1e-6)
    # a row that sees no key (Sq > Sk): the plain m + log(max(l, 1e-30))
    assert (lse[~seen] == -1e30).all()


@pytest.mark.parametrize("sq,sk", [(1, 1), (64, 64), (65, 65), (130, 130),
                                   (100, 300), (200, 70), (4096, 4096),
                                   (1, 129), (127, 128), (129, 1000)])
def test_bwd_plan_visits_exactly_the_causal_tiles(sq, sk):
    q = torch.empty((2, sq, 8, 64))
    k = torch.empty((2, sk, 2, 64))
    p = tflash.bwd_plan(q, k, k)
    bq, bk = p.bq, p.bk
    assert (p.n_q_tiles, p.n_k_tiles) == (-(-sq // bq), -(-sk // bk))
    assert p.dq_q_tiles == -(-sq // p.dq_bq)
    assert p.dkdv_blocks == p.n_k_tiles * 2 * 2
    assert p.dq_blocks == p.dq_q_tiles * 8 * 2
    assert p.delta_blocks == -(-2 * 8 * sq // (256 // 16)) and not p.copies

    def seen(bq, bk):   # the tile pairs that hold a visible (query, key)
        vis = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + (sk - sq)
        per_tile = np.add.reduceat(np.add.reduceat(
            vis.astype(np.int64), np.arange(0, sq, bq), axis=0),
            np.arange(0, sk, bk), axis=1)
        return set(zip(*(x.tolist() for x in np.nonzero(per_tile))))

    want, want_dq = seen(bq, bk), seen(p.dq_bq, p.dq_bk)
    dkdv = {(t, kt) for kt in range(p.n_k_tiles)
            for t in range(p.first_q_tile[kt], p.n_q_tiles)}
    dq = {(t, kt) for t in range(p.dq_q_tiles)
          for kt in range(p.dq_trips[t])}
    assert dkdv == want and dq == want_dq
    for kt in range(p.n_k_tiles):   # the first query tile is the first seen
        first = [t for t, c in want if c == kt]
        assert p.first_q_tile[kt] == (min(first) if first else p.n_q_tiles)
    assert all(p.dq_trips[t] == len([c for a, c in want_dq if a == t])
               for t in range(p.dq_q_tiles))


def test_bwd_plan_copies_what_the_kernels_cannot_read():
    # values drawn, not left uninitialized: a NaN in the memory would
    # fail the equality check below whatever the copy did
    base = torch.randn((1, 10, 4, 64))
    k = torch.randn((1, 10, 2, 64))
    assert tflash.bwd_plan(base, k, k).copies == ()
    odd = torch.randn((1, 10, 4, 66))[..., :64]   # strides not % 4
    assert tflash.bwd_plan(odd, k, k).copies == ("q",)
    flat = torch.randn(1 * 10 * 2 * 64 + 1)[1:].view(1, 10, 2, 64)
    assert tflash.bwd_plan(base, k, flat).copies == ("v",)   # base
    # the copies are fresh, aligned tensors, even of a contiguous view
    for t in (odd, flat):
        (c,) = tflash._vec_ready(t)
        assert c.data_ptr() != t.data_ptr() and tflash._vec_ok(c)
        assert torch.equal(c, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d", [(2, 33, 33, 4, 2, 64),
                                            (1, 20, 50, 8, 2, 16),
                                            (1, 40, 30, 2, 1, 32)])
def test_flash_attention_fn_gives_q_k_v_the_plain_gradients(b, sq, sk, h,
                                                            kh, d, dtype):
    """The regression test of the detached-output fault: the port's flash
    attention, where q, k and v need grad, records a backward that hands
    each of them the plain backward's gradient (CPU: the plain versions;
    CUDA: the kernels, ``chip_smoke.py``)."""
    q, k, v, do = (torch.as_tensor(x).to(dtype)
                   for x in inputs(sq, b, sq, sk, h, kh, d))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tflash.flash_attention(*leaves)
    assert out.grad_fn is not None
    out.backward(do)
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out.detach(), o)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    for t, w in zip(leaves, want):
        assert t.grad is not None and torch.equal(t.grad, w)
    if sq > sk:   # rows that see no key: exactly 0
        assert (leaves[0].grad[:, :sq - sk] == 0).all()
    # a scalar loss hands the backward a dO with zero strides
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tflash.flash_attention(*leaves).float().sum().backward()
    ones = torch.ones_like(q)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, ones)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_no_grad_call_records_nothing():
    q, k, v, _ = (torch.as_tensor(x) for x in inputs(3, 1, 8, 8, 2, 1, 64))
    out = tflash.flash_attention(q, k, v)
    assert out.grad_fn is None and torch.equal(
        out, tref.ref_flash_attention(q, k, v))
    with torch.no_grad():
        out = tflash.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_backward_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k, v, do = (torch.as_tensor(x) for x in inputs(5, 1, 8, 8, 4, 2, 64))
    o, lse = tref.ref_flash_attention(q, k, v, return_lse=True)
    delta = tflash.flash_bwd_delta(o, do)
    assert delta.shape == (1, 4, 8)
    dk, dv = tflash.flash_bwd_dkdv(q, k, v, do, lse, delta)
    dq = tflash.flash_bwd_dq(q, k, v, do, lse, delta)
    want = tref.ref_flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    with pytest.raises(ValueError, match="lse and delta"):
        tflash.flash_bwd_dq(q, k, v, do, lse[:, :2], delta)
    with pytest.raises(ValueError, match="lse and delta"):
        tflash.flash_bwd_dkdv(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="o and dO"):
        tflash.flash_bwd_delta(o, do[:, :4])
    with pytest.raises(ValueError, match="o and dO"):
        tflash.flash_attention_bwd(q, k, v, o, lse, do.to(torch.bfloat16))
    with pytest.raises(TypeError):
        tflash.flash_attention_bwd(q, k.double(), v, o, lse, do)
