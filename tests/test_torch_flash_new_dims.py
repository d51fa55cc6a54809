"""Flash attention at head dims 112 (kimi-k2) and 8 (qwen2-0.5b's smoke
config), on the CPU.

* The plain version (``ref.ref_flash_attention``, what the wrapper takes
  for CPU tensors) against the JAX package's ``_chunked_attention`` (the
  XLA scan of its serving prefill, f32 logits) and ``ref_attention``, at
  ragged causal GQA shapes: within ``F32_TOL`` (3e-5, the JAX package's
  own kernel tests').
* The host plan (``flash_attention.plan``): D 112 takes the ``wgmma``
  designs with TMA boxes of 64 bf16 / 32 f32 columns over a tensor of 112
  (the kernels run D 128's tiles, TMA filling the columns past 112 with
  zeros); D 8 takes the ``mma`` designs, whose packing covers every
  (strip, head, batch) of H 7 / K 1 once.
* A CUDA tensor never takes the plain version: a call on one (a tensor
  that reports the card) goes to the kernel's launch or raises, and one
  whose inputs need grad goes through ``FlashAttentionFn`` to the
  forward's launch with the lse, and its backward to the backward
  kernels' launches (the design of its dtype and head dim), at every
  head dim the backward is now built for (8, 16, 32, 112).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import _chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_flash_plan import check_mma_cover  # noqa: E402

F32_TOL = 3e-5
# (B, Sq, Sk, H, K, D): kimi-k2's GQA group of 8 at D 112 and
# qwen2-0.5b-smoke's 7 heads over 1 at D 8, Sq = Sk and Sq < Sk, on and
# off the kernels' tiles (128 rows / keys; 64 and 32 in f32 at D 112;
# 16-row strips and 32-key tiles at D 8)
SHAPES = [(1, 130, 130, 8, 1, 112), (2, 37, 100, 16, 2, 112),
          (1, 1, 65, 8, 1, 112), (2, 12, 12, 7, 1, 8),
          (1, 45, 130, 7, 1, 8), (3, 33, 33, 14, 2, 8)]


def qkv(seed, b, sq, sk, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kh, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,kh,d", SHAPES)
def test_plain_flash_at_new_dims_matches_jax_chunked(b, sq, sk, h, kh, d):
    q, k, v = qkv(sq * 31 + d, b, sq, sk, h, kh, d)
    tops.flash_attention.launches = 0
    got = tops.flash_attention(*map(torch.as_tensor, (q, k, v)))
    assert tops.flash_attention.launches == 0  # the plain version
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    want = np.asarray(_chunked_attention(
        *map(jnp.asarray, (q, k, v)), True, sk - sq, 32, False, False))
    assert np.max(np.abs(got.numpy() - want)) < F32_TOL
    ref = np.asarray(jref.ref_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True))
    assert np.max(np.abs(got.numpy() - ref)) < F32_TOL
    tiled = tref.ref_flash_attention(*map(torch.as_tensor, (q, k, v)),
                                     bq=7, bk=33)
    assert float((tiled - got).abs().max()) < F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d112_plans_the_wgmma_designs_over_112_columns(dtype):
    """D 112 takes the D 128 tiles of its dtype's wgmma design; the TMA
    maps name the tensor's 112 columns, boxes of one 128-byte swizzle
    row, and the launcher's args carry D 112."""
    q = torch.zeros(2, 300, 64, 112, dtype=dtype)
    kv = torch.zeros(2, 300, 8, 112, dtype=dtype)
    p = fa.plan(q, kv, kv)
    es = q.element_size()
    want = "wgmma" if dtype == torch.bfloat16 else "wgmma_f32"
    assert p.design == fa.design(dtype, 112) == want and not p.copies
    assert fa.block_shape(dtype, 112) == fa.block_shape(dtype, 128)
    assert p.n_q_tiles == -(-300 // fa.block_shape(dtype, 112)[0])
    k_map = p.maps[1]
    assert k_map.dims == (112, 8, 300, 2)
    assert k_map.strides == (112 * es, 8 * 112 * es, 300 * 8 * 112 * es)
    assert k_map.box == (fa.SWIZZLE_BYTES // es, 1,
                         fa.block_shape(dtype, 112)[1], 1)
    # bf16 maps q too; f32 reads q through its strides
    assert (p.maps[0] is None) == (dtype == torch.float32)
    args = list(p.args)
    assert args[5] == 112 and args[7] == fa.DESIGNS.index(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 12, 16, 17, 33, 130])
def test_d8_plans_the_mma_designs_with_seven_heads(dtype, sq):
    """D 8 takes its dtype's mma design. H 7 / K 1 has no even head
    packing: a block holds 7 heads of one strip or 1 head of up to 8
    strips, and every (strip, head, batch) is on exactly one warp."""
    es = torch.empty((), dtype=dtype).element_size()
    want = "mma" if dtype == torch.bfloat16 else "mma_f32"
    assert fa.design(dtype, 8) == want
    for sk in (sq, sq + 20, max(sq - 5, 0)):
        p = check_mma_cover(2, sq, sk, 7, 1, 8, es)
        assert p.heads_per_block == (7 if p.strips_per_block == 1 else 1)
    q = torch.zeros(2, sq, 7, 8, dtype=dtype)
    kv = torch.zeros(2, sq, 1, 8, dtype=dtype)
    fp = fa.plan(q, kv, kv)
    assert fp.design == want and not fp.copies
    assert list(fp.args)[5] == 8 and list(fp.args)[51:] == [
        fp.mma.strips_per_block, fp.mma.heads_per_block,
        fp.mma.kv_heads_per_block, fp.mma.stages, fp.mma.smem]


class OnCard(torch.Tensor):
    """A CPU tensor that reports the CUDA card as its device: what the
    wrapper sees of a tensor on the card, on a machine without one."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        owner = getattr(getattr(func, "__self__", None), "__name__", "")
        if getattr(func, "__name__", "") == "__get__" and owner == "device":
            return torch.device("cuda", 0)
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def on_card(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(OnCard)


class PlainRan(Exception):
    pass


class Launched(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [8, 16, 32, 112])
def test_a_card_call_with_grad_goes_to_the_backward_kernels(d, dtype,
                                                            monkeypatch):
    """With grad, a tensor on the card goes through ``FlashAttentionFn``
    to the forward's launch with an lse buffer, and the backward's
    wrappers go to their kernels' launches with the plan of the design of
    (dtype, D), never to a plain version and never to a
    NotImplementedError. The launches are stopped where the kernel would
    be called (there is no card here): ``torch.empty`` on the card cannot
    allocate on this machine, so the buffers are made on the CPU."""
    def plain(*a, **k):
        raise PlainRan

    for name in ("ref_flash_attention", "ref_flash_attention_bwd",
                 "ref_flash_bwd_delta"):
        monkeypatch.setattr(tref, name, plain)
    empty = torch.empty

    def cpu_empty(*a, **k):
        k.pop("device", None)
        return empty(*a, **k)

    asked = []

    def kernel_fn(source, symbol, argtypes):
        def launch(*args):
            asked.append((symbol, args))
            raise Launched
        return launch

    monkeypatch.setattr(fa.torch, "empty", cpu_empty)
    monkeypatch.setattr(fa._build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(fa.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    entered = []
    forward = fa.FlashAttentionFn.forward

    def spy(ctx, *args):
        entered.append(len(args))
        return forward(ctx, *args)

    monkeypatch.setattr(fa.FlashAttentionFn, "forward", staticmethod(spy))
    q = on_card(1, 40, 4, d, dtype=dtype).requires_grad_()
    kv = on_card(1, 40, 2, d, dtype=dtype)
    assert q.device.type == "cuda"
    with pytest.raises(Launched):
        tops.flash_attention(q, kv, kv)
    assert entered == [3]
    (symbol, args), = asked
    assert symbol == "flash_attention_launch" and args[4] != 0  # the lse
    plan = list(args[5])
    assert plan[5] == d and fa.DESIGNS[plan[7]] == fa.design(dtype, d)
    # the backward's three wrappers, each to its kernel's launch
    x = on_card(1, 40, 4, d, dtype=dtype)
    rows = on_card(1, 4, 40)
    kind = fa.design(dtype, d)
    for call, want in (
            (lambda: fa.flash_bwd_delta(x, x), "flash_bwd_delta_launch"),
            (lambda: fa.flash_bwd_dkdv(x, kv, kv, x, rows, rows),
             "flash_bwd_dkdv_launch"),
            (lambda: fa.flash_bwd_dq(x, kv, kv, x, rows, rows),
             "flash_bwd_dq_launch")):
        asked.clear()
        with pytest.raises(Launched):
            call()
        (symbol, args), = asked
        assert symbol == want
        plan = list(next(a for a in args if isinstance(a, ctypes.Array)))
        assert plan[5] == d and fa.BWD_DESIGNS[plan[24]] == kind
        assert len(plan) == 114 + 11 * (kind in fa.MMA_DESIGNS)


@pytest.mark.parametrize("d", [8, 112])
def test_a_card_call_never_takes_the_plain_version(d, monkeypatch):
    """At the new head dims a tensor on the card goes to the kernel's
    launch (which needs the card: here it raises) and never to the plain
    version, and nothing counts as launched."""
    class PlainRan(Exception):
        pass

    def plain(*a, **k):
        raise PlainRan

    monkeypatch.setattr(tref, "ref_flash_attention", plain)
    tops.flash_attention.launches = 0
    q, kv = on_card(1, 4, 4, d), on_card(1, 4, 2, d)
    with pytest.raises(Exception) as err:
        tops.flash_attention(q, kv, kv)
    assert not isinstance(err.value, PlainRan)
    assert tops.flash_attention.launches == 0
    # a head dim with no design raises on the card as on the CPU
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(on_card(1, 4, 4, 96), on_card(1, 4, 2, 96),
                             on_card(1, 4, 2, 96))
    assert fa.HEAD_DIMS == (8, 16, 32, 64, 112, 128)
