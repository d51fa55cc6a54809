"""whisper-medium's encoder-decoder (family ``encdec``) through the port
against the JAX package, on the CPU.

whisper-smoke (2 + 2 layers, d 64, 4 heads of 16), its weights drawn in
the JAX package's layout from a numpy generator and carried across by
``models/weights.from_jax_tree``; the audio frames are seeded numpy. In
f32 with ``attn_impl="xla"`` both packages do the same arithmetic in
another order: ``encode``, the prefill's logits and ``WhisperState``
(every layer's self-attention ring, padded for decode, and cross K/V),
decode steps after ``pad_to`` and the loss with its metrics agree within
``F32_TOL``, and the loss's gradients within ``GRAD_TOL`` of
``jax.grad``'s. The ``chunked`` prefill (the port's flash path; on the
CPU its plain version) is held as the dense family's is
(``tests/test_torch_models.py``): in f32 against JAX's ``xla`` within
``F32_TOL``, in bf16 against JAX's own ``chunked`` (whose logits stay
bf16) within ``BF16_TOL``. The whisper cases of
``tests/test_models_decode.py`` and ``tests/test_models_smoke.py`` are
mirrored on the port's own seeded weights.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch.steps import make_serve_step as jmake_serve_step  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.models.transformer import FwdOpts as JOpts  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.steps import (default_hyper,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import FwdOpts, batch_specs, build, weights  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.train_loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.tree import leaves_with_path, tree_leaves  # noqa: E402

ARCH = "whisper-medium"
# tolerances on max |port - jax| over max(1, max |jax|)
F32_TOL = 1e-5    # f32: the same arithmetic in another order
GRAD_TOL = 1e-4   # each gradient leaf, over its largest |jax.grad| entry
BF16_TOL = 0.05   # the dense family's: JAX's bf16 chunked prefill logits
                  # and p against the port's f32 ones
B, S, N = 2, 12, 6  # batch, prompt, decode steps
ROOT = os.path.join(os.path.dirname(__file__), "..")


def configs(dtype="float32"):
    jc = dataclasses.replace(jbase.get_smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(tbase.get_smoke_config(ARCH), dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def tree():
    """whisper-smoke's weights in the JAX package's layout, f32, from a
    numpy generator (the port's init rules: models/weights.py)."""
    return weights.random_tree(tbase.get_smoke_config(ARCH),
                               np.random.default_rng(0))


def inputs(cfg, seed=1, s=S + N):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(3, cfg.vocab, (B, s)).astype(np.int32)
    return enc, toks


def err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0,
                                                  float(np.abs(want).max()))


def jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_sinusoid_and_encode_match_jax(tree):
    """The positions and the encoder's output. At whisper-medium's 1,500
    x 1,024 the inverse frequencies equal the JAX package's bit for bit,
    and the sines and cosines of their f32 angles are held to f64 ones:
    XLA's f32 sine on the CPU is 1.2e-4 off at angles past 1,000 rad
    (ROADMAP.md Queue 3), the port's within f32 rounding."""
    jc, tc = configs()
    s, d = tc.encoder_seq, tc.d_model
    assert err(twh._sinusoid(s, d), jwh._sinusoid(s, d)) < F32_TOL
    inv = twh._inv_freq(1024, "cpu")
    dim = jnp.arange(512, dtype=jnp.float32)
    assert np.array_equal(inv.numpy(), np.asarray(
        1.0 / (10000 ** (dim / 511))))
    ang = np.arange(1500, dtype=np.float32)[:, None] * inv.numpy()[None, :]
    exact = np.concatenate([np.sin(ang.astype(np.float64)),
                            np.cos(ang.astype(np.float64))], axis=1)
    assert np.abs(twh._sinusoid(1500, 1024).numpy() - exact).max() < 1e-7
    assert np.abs(np.asarray(jwh._sinusoid(1500, 1024)) - exact).max() < 2e-4
    params = weights.from_jax_tree(tc, tree, device="cpu")
    enc, _ = inputs(tc)
    want = jwh.encode(jax_params(tree), jc, jnp.asarray(enc))
    with torch.inference_mode():
        got = twh.encode(params, tc, torch.as_tensor(enc))
    assert got.dtype == torch.float32 and err(got, want) < F32_TOL


def test_prefill_state_and_decode_match_jax(tree):
    """Prefill with decode headroom: logits, every layer's padded ring
    and cross K/V, pos and cache_len; then N decode steps through each
    package's serve step, with the rows each step writes."""
    jc, tc = configs()
    params = weights.from_jax_tree(tc, tree, device="cpu")
    enc, toks = inputs(tc)
    jl, js = jbuild(jc).prefill(
        jax_params(tree), {"enc_embeds": jnp.asarray(enc),
                           "tokens": jnp.asarray(toks[:, :S])},
        JOpts(attn_impl="xla"), pad_to=S + N)
    tl, ts = build(tc).prefill(
        params, {"enc_embeds": torch.as_tensor(enc),
                 "tokens": torch.as_tensor(toks[:, :S])},
        FwdOpts(attn_impl="xla"), pad_to=S + N)
    assert tl.shape == (B, 1, tc.vocab) and tl.dtype == torch.float32
    assert err(tl, jl) < F32_TOL
    assert (ts.pos, ts.cache_len) == (int(js.pos), int(js.cache_len)) == (S, S)

    def same_state():
        for l in range(tc.n_layers):
            assert err(ts.self_caches[l].k, js.self_caches.k[l]) < F32_TOL
            assert err(ts.self_caches[l].v, js.self_caches.v[l]) < F32_TOL
            assert err(ts.cross_k[l], js.cross_k[l]) < F32_TOL
            assert err(ts.cross_v[l], js.cross_v[l]) < F32_TOL

    same_state()
    assert ts.self_caches[0].k.shape == (B, S + N, tc.n_kv_heads, tc.hd)
    assert ts.cross_k[0].shape == (B, tc.encoder_seq, tc.n_kv_heads, tc.hd)
    jstep, tstep = jmake_serve_step(jc), make_serve_step(tc)
    for t in range(S, S + N):
        jl, js = jstep(jax_params(tree), jnp.asarray(toks[:, t:t + 1]), js)
        tl, ts = tstep(params, torch.as_tensor(toks[:, t:t + 1]), ts)
        assert err(tl, jl) < F32_TOL, t
        assert (ts.pos, ts.cache_len) == (int(js.pos), int(js.cache_len))
    assert ts.pos == S + N
    same_state()


@pytest.mark.parametrize("dtype,jax_impl,tol", [
    ("float32", "xla", F32_TOL), ("bfloat16", "chunked", BF16_TOL)])
def test_chunked_prefill_within_the_dense_tolerance(tree, dtype, jax_impl,
                                                    tol):
    """The port's ``chunked`` prefill (the flash path) against JAX's
    ``jax_impl``: logits, and each layer's self-attention K/V."""
    jc, tc = configs(dtype)
    params = weights.from_jax_tree(tc, tree, device="cpu")
    enc, toks = inputs(tc, seed=2)
    jl, js = jbuild(jc).prefill(
        jax_params(tree), {"enc_embeds": jnp.asarray(enc),
                           "tokens": jnp.asarray(toks)},
        JOpts(attn_impl=jax_impl))
    tl, ts = build(tc).prefill(params, {"enc_embeds": torch.as_tensor(enc),
                                        "tokens": torch.as_tensor(toks)})
    assert err(tl, jl) < tol, err(tl, jl)
    for l in range(tc.n_layers):
        assert err(ts.self_caches[l].k, np.asarray(
            js.self_caches.k[l], np.float32)) < tol


def labelled(cfg, seed=3):
    enc, toks = inputs(cfg, seed, S + 1)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                       # masked labels
    return {"enc_embeds": enc, "tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_loss_metrics_and_gradients_match_jax(tree, impl):
    """f32: loss, ce, z_loss, moe_aux and tokens within F32_TOL, every
    gradient leaf within GRAD_TOL of ``jax.grad``'s (the port's layers
    under the default remat, the JAX package's not: the same values).
    The key biases' gradients are 0 in exact arithmetic (a softmax takes
    no shift shared by every key), so both packages give rounding
    residue there: those are held to GRAD_TOL of the largest gradient."""
    jc, tc = configs()
    batch = labelled(tc)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                                  JOpts(attn_impl=impl)),
        has_aux=True)(jax_params(tree))
    params = weights.from_jax_tree(tc, tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    loss, m = build(tc).loss(params, {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                             FwdOpts(attn_impl=impl))
    loss.backward()
    assert err(loss.detach(), jloss) < F32_TOL
    for k in ("ce", "z_loss", "moe_aux", "tokens"):
        assert err(m[k].detach(), jm[k]) < F32_TOL, k
    assert float(m["tokens"]) == B * S - 3

    def grad_tree(t):
        if isinstance(t, dict):
            return {k: grad_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [grad_tree(v) for v in t]
        return t.grad

    got = dict(leaves_with_path(weights.to_jax_tree(tc, grad_tree(params))))
    want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert got.keys() == want.keys() and len(got) == 41
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        scale = top if path.endswith("['bk']") else float(np.abs(w).max())
        assert float(np.abs(got[path] - w).max()) <= GRAD_TOL * scale, path


def test_decode_matches_full_forward():
    """``test_models_decode.py::test_decode_matches_full_forward`` for
    whisper on the port's own bf16 weights: a decode step after a padded
    prefill equals the prefill of the longer prompt, within its 0.2."""
    _, tc = configs("bfloat16")
    bundle = build(tc)
    params = bundle.init(0, device="cpu")
    rng = np.random.default_rng(0)
    enc = torch.as_tensor(rng.normal(size=(B, tc.encoder_seq, tc.d_model)),
                          dtype=torch.float32).to(torch.bfloat16)
    toks = torch.as_tensor(rng.integers(0, tc.vocab, (B, S + 1)))
    xla = FwdOpts(attn_impl="xla")
    _, state = bundle.prefill(params, {"enc_embeds": enc,
                                       "tokens": toks[:, :S]}, xla,
                              pad_to=S + 4)
    logits_d, state2 = bundle.decode(params, toks[:, S:S + 1], state)
    logits_ref, _ = bundle.prefill(params, {"enc_embeds": enc,
                                            "tokens": toks}, xla)
    assert state2.pos == S + 1
    assert float((logits_d - logits_ref).abs().max()) < 0.2


def smoke_batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"enc_embeds": torch.as_tensor(
                rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)),
                dtype=torch.float32).to(torch.bfloat16),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))}


def test_forward_loss_finite_and_train_step_updates_params():
    """``test_models_smoke.py``'s whisper cases: the loss is finite and in
    (2, 12); a full train step (grad, clip, AdamW) moves the parameters
    and leaves no NaN."""
    _, tc = configs("bfloat16")
    bundle = build(tc)
    params = bundle.init(0, device="cpu")
    loss, metrics = bundle.loss(params, smoke_batch(tc))
    assert 2.0 < float(loss) < 12.0 and np.isfinite(float(metrics["ce"]))
    run = RunConfig(attn_impl="xla", learning_rate=1e-3)
    hyper = default_hyper(tc, run)
    state = {"params": params, "opt": init_state(params, hyper)}
    new_state, m = make_train_step(tc, run, hyper)(state, smoke_batch(tc))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    moved = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(params), tree_leaves(new_state["params"])))
    assert moved > 0


def test_trainer_runs_whisper_batches_on_the_cpu(tmp_path):
    """``Trainer`` on batches of ``enc_embeds``, ``tokens`` and
    ``labels`` with ``chunked`` attention and AdamW: finite losses that
    fall over a repeated batch."""
    _, tc = configs("float32")
    rng = np.random.default_rng(5)
    toks = rng.integers(3, tc.vocab, (2, S + 1)).astype(np.int32)
    batch = {"enc_embeds": rng.normal(size=(2, tc.encoder_seq, tc.d_model)
                                      ).astype(np.float32),
             "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tr = Trainer(tc, RunConfig(learning_rate=3e-3),
                 TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path)),
                 seed=0, device="cpu")
    hist = tr.run_loop(iter([batch] * 4))
    losses = [h["loss"] for h in hist]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("shape", list(jbase.SHAPES))
def test_batch_specs_match_jax(shape):
    want = jmodel.batch_specs(jbase.get_config(ARCH), jbase.SHAPES[shape])
    got = batch_specs(tbase.get_config(ARCH), tbase.SHAPES[shape])
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_weights_round_trip_in_the_jax_layout(tree):
    """``to_jax_tree(from_jax_tree(t)) == t`` bit for bit, in the JAX
    package's structure and shapes (``abstract_params``), and the port's
    seeded init has the spec's layout."""
    _, tc = configs()
    back = weights.to_jax_tree(tc, weights.from_jax_tree(tc, tree,
                                                         device="cpu"))
    want = jbuild(jbase.get_smoke_config(ARCH)).abstract_params()
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(want))
    for a, b, s in zip(jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(want)):
        assert a.dtype == np.float32 and a.shape == s.shape
        assert a.tobytes() == b.tobytes()
    params = build(tc).init(3, device="cpu")
    assert len(params["enc_layers"]) == tc.encoder_layers
    assert len(params["dec_layers"]) == tc.n_layers
    assert params["embed"]["head"].shape == (tc.d_model, tc.vocab)


def test_engine_and_launcher_refuse_whisper(tree):
    """The JAX package's engine feeds ``{"tokens"}`` alone, so its whisper
    prefill fails in the model; the port's engine and serving launcher
    refuse the encoder-decoder before building it, naming
    ``ModelBundle.prefill``."""
    jc, tc = configs()
    with pytest.raises(KeyError, match="enc_embeds"):
        JEngine(jc, jax_params(tree)).generate(np.full((1, 4), 3, np.int32))
    params = weights.from_jax_tree(tc, tree, device="cpu")
    with pytest.raises(NotImplementedError, match="ModelBundle.prefill"):
        ServeEngine(tc, params)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "1"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "ModelBundle.prefill" in out.stderr
