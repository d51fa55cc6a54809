"""The port's flash attention against the JAX package's, on the CPU.

The same numpy q, k, v go through the Pallas kernel body
(``repro.kernels.ops.flash_attention(..., interpret=True)``) and
``ref_attention``, and through ``repro_torch.kernels.ops.flash_attention``,
whose wrapper takes its plain torch version (``ref.ref_flash_attention``)
for CPU tensors; the CUDA kernel is held against that on the card by
``chip_smoke.py``. Tolerances are the JAX package's own kernel tests':
3e-5 in float32, 3e-2 in bfloat16 (tests/test_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_TOL = 3e-5
BF16_TOL = 3e-2

# the five shapes of the JAX package's kernel test, a GQA group of 7
# (qwen2-0.5b's 14 query heads over 2 kv heads), ragged tiles, and the
# Meta-pipe encoder's 32-token sequences of 8 heads at D 32 and 16 (the
# shapes the f32 mma design was written for) with Sq > Sk beside them
SHAPES = [
    (2, 256, 256, 8, 4, 64),
    (1, 100, 300, 4, 4, 32),
    (1, 1, 129, 8, 8, 64),
    (1, 37, 37, 2, 1, 128),
    (2, 128, 640, 4, 2, 16),
    (1, 45, 130, 14, 2, 64),
    (4, 32, 32, 8, 8, 32),
    (4, 32, 32, 8, 8, 16),
]


def qkv(rng, b, sq, sk, h, kh, d, dtype=np.float32):
    return (rng.normal(size=(b, sq, h, d)).astype(dtype),
            rng.normal(size=(b, sk, kh, d)).astype(dtype),
            rng.normal(size=(b, sk, kh, d)).astype(dtype))


def port(q, k, v, dtype=torch.float32):
    return tops.flash_attention(*(torch.as_tensor(x).to(dtype)
                                  for x in (q, k, v)))


@pytest.mark.parametrize("b,sq,sk,h,kh,d", SHAPES)
def test_flash_attention_f32_matches_pallas_body_and_ref(b, sq, sk, h, kh,
                                                         d):
    q, k, v = qkv(np.random.default_rng(sq * 7 + sk), b, sq, sk, h, kh, d)
    got = port(q, k, v)
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    got = got.numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, interpret=True))
    want = np.asarray(jref.ref_attention(jq, jk, jv))
    assert np.max(np.abs(got - pallas)) < F32_TOL
    assert np.max(np.abs(got - want)) < F32_TOL
    # the port's own full-logits oracle agrees too
    full = tref.ref_attention(*(torch.as_tensor(x) for x in (q, k, v)))
    assert np.max(np.abs(got - full.numpy())) < F32_TOL


def test_flash_attention_bf16_matches_pallas_body_and_ref():
    """The JAX package's bf16 case, plus the model's head dim at GQA 4."""
    rng = np.random.default_rng(0)
    for shape in [(1, 64, 64, 4, 2, 32), (1, 96, 160, 8, 2, 64)]:
        q, k, v = qkv(rng, *shape)
        got = port(q, k, v, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        pallas = np.asarray(jops.flash_attention(jq, jk, jv, interpret=True),
                            np.float32)
        want = np.asarray(jref.ref_attention(jq, jk, jv), np.float32)
        assert np.max(np.abs(got - pallas)) < BF16_TOL
        assert np.max(np.abs(got - want)) < BF16_TOL


def test_flash_attention_rows_that_see_no_key_are_zero():
    """Sq > Sk: the first Sq - Sk queries precede every key. The Pallas
    kernel gives 0 there (acc / max(l, 1e-30)); ref_attention gives NaN.
    The rest matches both."""
    b, sq, sk, h, kh, d = 1, 150, 40, 4, 2, 32
    q, k, v = qkv(np.random.default_rng(5), b, sq, sk, h, kh, d)
    got = port(q, k, v).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, interpret=True))
    want = np.asarray(jref.ref_attention(jq, jk, jv))
    blind = sq - sk
    assert (got[:, :blind] == 0).all() and (pallas[:, :blind] == 0).all()
    assert np.isnan(want[:, :blind]).all()
    assert np.max(np.abs(got - pallas)) < F32_TOL
    assert np.max(np.abs(got[:, blind:] - want[:, blind:])) < F32_TOL


def test_flash_plain_version_tiles_do_not_matter():
    """The plain version's (bq, bk) tiling changes the order of the online
    softmax only: 128-tiles (the Pallas kernel's) and the 1024-tiles
    chip_smoke.py runs at 32k tokens agree."""
    q, k, v = (torch.as_tensor(x) for x in qkv(np.random.default_rng(2), 1,
                                                300, 1100, 4, 2, 16))
    a = tref.ref_flash_attention(q, k, v)
    b = tref.ref_flash_attention(q, k, v, bq=1024, bk=1024)
    c = tref.ref_flash_attention(q, k, v, bq=7, bk=33)
    assert float((a - b).abs().max()) < F32_TOL
    assert float((a - c).abs().max()) < F32_TOL


def test_flash_wrapper_checks_inputs_and_counts_no_cpu_launch():
    tops.flash_attention.launches = 0
    q = torch.zeros(1, 4, 4, 64)
    kv = torch.zeros(1, 4, 2, 64)
    tops.flash_attention(q, kv, kv)
    assert tops.flash_attention.launches == 0
    assert tops.KERNELS["flash_attention"] is tops.flash_attention
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(torch.zeros(1, 4, 4, 96),
                             torch.zeros(1, 4, 2, 96),
                             torch.zeros(1, 4, 2, 96))
    with pytest.raises(ValueError, match="group"):
        tops.flash_attention(torch.zeros(1, 4, 3, 64), kv, kv)
    with pytest.raises(TypeError):
        tops.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(NotImplementedError):
        tops.flash_attention(q, kv, kv, causal=False)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q, kv, torch.zeros(1, 4, 64, 2).transpose(2, 3))
    # a strided (non-contiguous but head-dim-contiguous) q is taken as is
    qq = torch.randn(1, 4, 8, 64)[:, :, ::2]
    assert torch.equal(tops.flash_attention(qq, kv, kv),
                       tops.flash_attention(qq.contiguous(), kv, kv))


def test_causal_pairs_counts_visible_pairs():
    for sq, sk in [(1, 1), (256, 256), (100, 300), (150, 40), (1, 129),
                   (5, 0)]:
        brute = sum(max(0, min(i + sk - sq + 1, sk)) for i in range(sq))
        assert tflash.causal_pairs(sq, sk) == brute
