"""Training the decoder-only families through the port's flash backward,
on the CPU: each new config's smoke model in f32 (grok-1 and kimi-k2's
MoE, jamba's Mamba hybrid, olmo-1b, qwen1.5-4b, qwen2-0.5b at D 8,
qwen2-vl on embeddings with M-RoPE positions, rwkv6), the port's
``loss_fn`` with ``attn_impl="chunked"`` (``FlashAttentionFn``: the
flash forward's and backward's plain versions, what the kernels are held
to on the card) against ``jax.value_and_grad`` of the JAX package's
``loss_fn`` with ``chunked`` (its XLA scan, several chunks at this
length, differentiated by autodiff), on weights carried across by
``weights.from_jax_tree`` from one numpy tree.

Tolerances, on max |port - jax| over max(1, max |jax|): ``LOSS_TOL`` 1e-5
for the loss and its metrics (the same f32 arithmetic in another order,
as ``test_torch_model_families``); ``GRAD_TOL`` 1e-4 for every gradient
leaf: each leaf sums its per-token terms over the batch and, through the
backward's dK and dV, over the G query heads and the sequence, in
another order in each package (the port's plain backward tiles them by
64, JAX's scan by its chunk), and the scans of jamba and rwkv6 compose
their steps in another order too (the forward's ``SCAN_TOL`` is 1e-5 on
each element). The readings (f32 on the CPU) are at most 9.4e-6 where a
scan is on the path (jamba; rwkv6 6.7e-6) and 1.1e-6 where none is, so
the limit holds ten times the worst reading, while a wrong gradient (a
missing head's or tile's term) lands orders of magnitude above it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import build, weights  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import batch_specs  # noqa: E402
from repro_torch.train.tree import leaves_with_path  # noqa: E402
from test_torch_model_families import NEW_ARCHS  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 40    # tokens a row: several JAX chunks, ragged over the port's
JAX_CHUNK = 16  # 64-row plain tiles and the mma kernels' 16-row strips


def lm_inputs(cfg, seed: int) -> dict:
    """A training batch of the arch's inputs (``batch_specs``): token ids,
    or embeddings with M-RoPE's (3, B, S) positions whose t / h / w rows
    differ; labels with masked entries."""
    rng = np.random.default_rng(seed)
    spec = batch_specs(cfg, tbase.ShapeConfig("t", S, B, "train"))
    batch = {}
    if "embeds" in spec:
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(3, cfg.vocab, (B, S)).astype(np.int32)
    if "positions" in spec:
        t = np.arange(S)
        batch["positions"] = np.stack([
            np.broadcast_to(t, (B, S)), np.broadcast_to(t // 3, (B, S)),
            np.broadcast_to(t % 5 + 2 * np.arange(B)[:, None], (B, S))
        ]).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch["labels"][0, :3] = -100
    return batch


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want), initial=0.0)
                 / max(1.0, float(np.max(np.abs(want), initial=0.0))))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_chunked_loss_and_every_gradient_match_jax(arch, monkeypatch):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    tree = weights.random_tree(tc, np.random.default_rng(7))
    batch = lm_inputs(tc, 11)
    jopts = jtf.FwdOpts(attn_impl="chunked", attn_chunk=JAX_CHUNK)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jc, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jopts),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))

    params = weights.from_jax_tree(tc, tree, device="cpu")
    fa.flash_attention.launches = 0
    calls = []
    fwd = fa.FlashAttentionFn.forward

    def counted(ctx, q, k, v):
        calls.append(q.shape[-1])
        return fwd(ctx, q, k, v)

    monkeypatch.setattr(fa.FlashAttentionFn, "forward",
                        staticmethod(counted))
    (loss, m), grads = value_and_grad(lambda p: build(tc).loss(
        p, {k: torch.as_tensor(v) for k, v in batch.items()},
        ttf.FwdOpts(attn_impl="chunked")), params)
    # every attention layer through the flash autograd function, its
    # forward and remat's recomputation (rwkv6 has none), at the config's
    # head dim; the plain versions on the CPU
    n_attn = sum(kind == "attn" for kind, _ in ttf.layer_kinds(tc))
    assert calls == [tc.head_dim] * (2 * n_attn)
    assert fa.flash_attention.launches == 0
    assert rel(float(loss), float(jloss)) <= LOSS_TOL
    for k in ("ce", "z_loss", "moe_aux", "tokens"):
        assert rel(float(m[k]), float(jm[k])) <= LOSS_TOL, k
    got = dict(leaves_with_path(weights.to_jax_tree(tc, grads)))
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                        jgrads)))
    assert got.keys() == want.keys()
    errs = {path: rel(got[path], want[path]) for path in want}
    assert max(errs.values()) <= GRAD_TOL, max(errs.items(),
                                               key=lambda kv: kv[1])
    assert all(np.isfinite(g).all() for g in got.values())
