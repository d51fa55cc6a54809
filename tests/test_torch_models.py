"""The port's serving path against the JAX package's, on the CPU.

llama3.2-1b's smoke config, with weights drawn by the JAX package's
``init_param`` and carried across by ``repro_torch.models.weights``. The
JAX package's own ``init`` folds each parameter's path into its key with
Python's salted ``hash``, so it draws other weights in every process; the
fixture splits one root key over the leaves instead, so every run tests
the same weights. Two runs:

* exact: ``attn_impl="xla"`` and ``dtype="float32"`` in both packages:
  prefill logits and KV caches, 8 decode steps, within ``F32_TOL``; the
  greedy ids of ``ServeEngine.generate`` and ``Scheduler`` equal.
* bf16: the default ``"chunked"`` prefill in bfloat16. The JAX package's
  chunked prefill keeps its logits and probabilities in bf16
  (``compact_logits``), while the port's flash kernel keeps them in f32, as
  the Pallas kernel does: logits agree within ``BF16_TOL``, and greedy ids
  are compared wherever the top-2 logit margin exceeds twice that.

On the CPU the port's flash attention is its plain torch version; the CUDA
kernel is held against that on the card by ``chip_smoke.py``.
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

from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.layers import ParamSpec, init_param  # noqa: E402
from repro.models.transformer import FwdOpts as JOpts  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs import RunConfig, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import FwdOpts, build, weights  # noqa: E402
from repro_torch.models.transformer import init_caches  # noqa: E402
from repro_torch.obs.recorder import RECORDER  # noqa: E402
from repro_torch.serve import Scheduler, ServeConfig, ServeEngine  # noqa: E402

ARCH = "llama3.2-1b"
# tolerances on max |port - jax| over max(1, max |jax|): logits are below
# 1 at this size, so for them the tolerance is absolute; K/V caches reach
# about 10
F32_TOL = 1e-5    # f32: the same arithmetic in another order
BF16_TOL = 0.05   # bf16: the JAX prefill's bf16 logits and p (see the
                  # module docstring) against the port's f32 ones
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def jax_tree():
    """The smoke model's parameters under the JAX package's init rule,
    one key per leaf split from ``key(0)`` (see the module docstring)."""
    leaves, treedef = jax.tree_util.tree_flatten(
        jbuild(jax_smoke(ARCH)).spec,
        is_leaf=lambda x: isinstance(x, ParamSpec))
    keys = jax.random.split(jax.random.key(0), len(leaves))
    return treedef.unflatten([np.asarray(init_param(s, k))
                              for s, k in zip(leaves, keys)])


def configs(dtype):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    return jc, tc


def prompts(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(3, vocab, (b, s)).astype(
        np.int32)


def port_prefill(tc, params, toks, impl, pad_to):
    return build(tc).prefill(params, {"tokens": torch.as_tensor(toks)},
                             FwdOpts(attn_impl=impl), pad_to=pad_to)


def max_err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("dtype,jax_impl,impl,tol", [
    ("float32", "xla", "xla", F32_TOL),
    # the port's flash path against JAX's f32 full-logits attention: JAX's
    # own chunked prefill computes its logits in bf16 even at f32
    ("float32", "xla", "chunked", F32_TOL),
    ("bfloat16", "chunked", "chunked", BF16_TOL),
])
def test_prefill_and_decode_match_jax(jax_tree, jax_steps_cache, dtype,
                                      jax_impl, impl, tol):
    """Prefill logits and every layer's K/V cache (padded for decode),
    then 8 decode steps on the same tokens: logits within ``tol``, and the
    cache rows each step writes."""
    jc, tc = configs(dtype)
    params = weights.from_jax_tree(tc, jax_tree, device="cpu")
    b, s, n = 2, 12, 8
    toks = prompts(1, b, s + n, tc.vocab)
    steps = jax_steps(jax_steps_cache, jax_tree, dtype, jax_impl, toks, s)
    tl, ts = port_prefill(tc, params, toks[:, :s], impl, s + n)
    jl, pos, kv = steps[0]
    assert tl.shape == (b, 1, tc.vocab) and tl.dtype == torch.float32
    assert max_err(tl.numpy(), jl) < tol, max_err(tl.numpy(), jl)
    assert (ts.pos, ts.cache_len) == pos
    for l in range(tc.n_layers):
        for i in range(2):
            got, want = ts.caches[l][i], kv[i][l]
            assert got.shape == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert max_err(got.float().numpy(), want.astype(np.float32)) < tol
    for t in range(n):
        tok = toks[:, s + t:s + t + 1]
        tl, ts = build(tc).decode(params, torch.as_tensor(tok), ts)
        jl, pos, kv = steps[t + 1]
        assert max_err(tl.numpy(), jl) < tol, (t, max_err(tl.numpy(), jl))
        assert (ts.pos, ts.cache_len) == pos
    got = ts.caches[-1].k.float().numpy()
    assert max_err(got, kv[0][-1].astype(np.float32)) < tol


@pytest.fixture(scope="module")
def jax_steps_cache():
    return {}


def jax_steps(cache, jax_tree, dtype, impl, toks, s):
    """JAX's prefill of ``toks[:, :s]`` and a decode step for each further
    token: [(logits, (pos, cache_len), (K, V) stacked over layers)], kept
    in ``cache`` for the test cases that share them."""
    key = (dtype, impl, toks.tobytes(), s)
    if key not in cache:
        jc, _ = configs(dtype)
        jb = jbuild(jc)
        jl, js = jb.prefill(jax_tree, {"tokens": jnp.asarray(toks[:, :s])},
                            JOpts(attn_impl=impl), pad_to=toks.shape[1])
        out = []
        for t in range(s, toks.shape[1] + 1):
            c = js.caches[0]
            out.append((np.asarray(jl), (int(js.pos), int(js.cache_len)),
                        (np.asarray(c.k), np.asarray(c.v))))
            if t < toks.shape[1]:
                jl, js = jb.decode(jax_tree, jnp.asarray(toks[:, t:t + 1]),
                                   js)
        cache[key] = out
    return cache[key]


def test_decode_ring_at_capacity(jax_tree):
    """A cache with no headroom: decode overwrites the oldest slot."""
    jc, tc = configs("float32")
    params = weights.from_jax_tree(tc, jax_tree, device="cpu")
    toks = prompts(2, 1, 10, tc.vocab)
    jl, js = jbuild(jc).prefill(jax_tree, {"tokens": jnp.asarray(toks[:, :6])},
                                JOpts(attn_impl="xla"))
    tl, ts = port_prefill(tc, params, toks[:, :6], "xla", None)
    for t in range(6, 10):
        jl, js = jbuild(jc).decode(jax_tree, jnp.asarray(toks[:, t:t + 1]),
                                   js)
        tl, ts = build(tc).decode(params, torch.as_tensor(toks[:, t:t + 1]),
                                  ts)
        assert max_err(tl.numpy(), jl) < F32_TOL
    assert ts.cache_len == int(js.cache_len) == 6 and ts.pos == 10


def forced_logits(tc, params, batch, ids):
    """The port's logits at every generated position, fed the given ids
    (teacher forcing): (B, T, V) numpy."""
    pad_to = batch.shape[1] + ids.shape[1]
    bundle = build(tc)
    logits, state = port_prefill(tc, params, batch, "chunked", pad_to)
    out = [logits[:, 0].numpy()]
    for t in range(ids.shape[1] - 1):
        logits, state = bundle.decode(
            params, torch.as_tensor(ids[:, t:t + 1].astype(np.int64)), state)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1)


def generate_spans():
    """The ``serve.generate`` spans in the flight recorder, oldest first."""
    return [e for e in RECORDER.events("span")
            if e["name"] == "serve.generate"]


def check_ids(tc, params, batch, got, want):
    """bf16 greedy ids: equal up to each row's first difference, and there
    the JAX token's top-2 margin in the port's logits is within twice the
    tolerance (a near tie that bf16 rounding may flip)."""
    logits = forced_logits(tc, params, batch, want)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    am = logits.argmax(-1)
    decided = margin > 2 * BF16_TOL
    assert (am[decided] == want[decided]).all()
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if len(diff):
            assert margin[r, diff[0]] <= 2 * BF16_TOL, (r, diff[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_generate_matches_jax(jax_tree, dtype):
    jc, tc = configs(dtype)
    impl = "xla" if dtype == "float32" else "chunked"
    params = weights.from_jax_tree(tc, jax_tree, device="cpu")
    batch = prompts(3, 3, 16, tc.vocab)
    jeng = JEngine(jc, jax_tree, JServeConfig(max_new_tokens=10),
                   run=JRunConfig(attn_impl=impl))
    teng = ServeEngine(tc, params, ServeConfig(max_new_tokens=10),
                       run=RunConfig(attn_impl=impl))
    RECORDER.clear()
    want, got = jeng.generate(batch), teng.generate(batch)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "float32":
        assert np.array_equal(got, want)
        # EOS masking: stop at a token the JAX engine emits mid-stream
        eos = int(want[0, 3])
        jeng.scfg.eos_id = teng.scfg.eos_id = eos
        want, got = jeng.generate(batch), teng.generate(batch)
        assert np.array_equal(got, want)
        assert (got[0, 4:] == 0).all()
        assert teng.stats == jeng.stats
    else:
        check_ids(tc, params, batch, got, want)
    spans = generate_spans()
    assert [(e["batch"], e["seq"]) for e in spans] == [(3, 16)] * len(spans)
    assert spans[0]["decode_steps"] == 10  # one decode after each token
    assert set(spans[0]["stages"]) == {"prefill", "decode"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scheduler_matches_jax(jax_tree, dtype):
    """6 requests of 4-48 tokens through power-of-two buckets (16, 32,
    64): the same outputs per request."""
    jc, tc = configs(dtype)
    impl = "xla" if dtype == "float32" else "chunked"
    params = weights.from_jax_tree(tc, jax_tree, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [(f"r{i}", rng.integers(3, tc.vocab, size=int(n)))
            for i, n in enumerate([4, 9, 17, 30, 33, 47])]
    jeng = JEngine(jc, jax_tree, JServeConfig(max_new_tokens=6),
                   run=JRunConfig(attn_impl=impl))
    teng = ServeEngine(tc, params, ServeConfig(max_new_tokens=6),
                       run=RunConfig(attn_impl=impl))
    js, ts = JScheduler(jeng, max_batch=8), Scheduler(teng, max_batch=8)
    RECORDER.clear()
    for rid, tok in reqs:
        js.submit(rid, tok)
        ts.submit(rid, tok)
    jr, tr = js.run_until_drained(), ts.run_until_drained()
    assert tr["n_done"] == jr["n_done"] == 6
    assert tr["p99_latency_s"] >= tr["p50_latency_s"] >= 0
    assert sorted(e["seq"] for e in generate_spans()) == [16, 32, 64]
    for rid, tok in reqs:
        got, want = ts.done[rid].output, js.done[rid].output
        if dtype == "float32":
            assert np.array_equal(got, want), rid
        else:
            bucket = 16 if len(tok) <= 16 else 32 if len(tok) <= 32 else 64
            batch = np.zeros((1, bucket), np.int32)
            batch[0, :len(tok)] = tok
            # a bucket holds several requests; one row's logits do not
            # depend on the other rows, so each is checked alone
            check_ids(tc, params, batch, got[None], want[None])


def test_port_init_launcher_and_unported_families():
    """The port's own seeded init is deterministic; the launcher runs on
    the CPU; whisper-medium's config (its family raised here until it
    was ported) has the published dims; the training loss (ported since)
    is a finite 0-d f32 tensor on the port's own weights."""
    _, tc = configs("bfloat16")
    a = build(tc).init(7, device="cpu")
    b = build(tc).init(7, device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["wo"], b["layers"][1]["mlp"]["wo"])
    assert a["layers"][0]["mlp"]["wo"].dtype == torch.bfloat16
    assert a["final_norm"]["scale"].dtype == torch.float32
    tree = weights.to_jax_tree(tc, a)
    back = weights.from_jax_tree(tc, tree, device="cpu")
    assert torch.equal(back["embed"]["tok"], a["embed"]["tok"])
    caches = init_caches(tc, 2, 9, device="cpu")
    assert len(caches) == tc.n_layers
    assert caches[0].k.shape == (2, 9, tc.n_kv_heads, tc.hd)
    assert caches[0].v.dtype == torch.bfloat16
    toks = torch.as_tensor(prompts(0, 2, 9, tc.vocab))
    loss, metrics = build(tc).loss(a, {"tokens": toks, "labels": toks})
    assert loss.shape == () and loss.dtype == torch.float32
    assert torch.isfinite(loss) and float(metrics["tokens"]) == 18
    from repro_torch.configs import get_config
    wcfg = get_config("whisper-medium")
    assert (wcfg.family, wcfg.n_layers, wcfg.encoder_layers, wcfg.d_model,
            wcfg.n_heads, wcfg.n_kv_heads, wcfg.hd, wcfg.encoder_seq,
            wcfg.vocab) == ("encdec", 24, 24, 1024, 16, 16, 64, 1500, 51865)
    assert not wcfg.tie_embeddings and wcfg.qkv_bias
    tops.flash_attention.launches = 0
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "4", "--max-new", "4"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "4 requests in" in out.stdout
    assert tops.flash_attention.launches == 0  # CPU tensors launch nothing


def test_port_init_keeps_the_model_well_conditioned():
    """The port's init takes the contracted dims as the attention weights'
    fan-in; the JAX package's rule (the head count for wq/wk/wv, head_dim
    for wo) gives attention logits of std about 64 at head_dim 64, nearly
    one-hot softmaxes, and a model where a 1e-7 relative change of the
    embedding moves the logits by four orders of magnitude more after 8
    layers. With the port's rule it stays at the f32 rounding level."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=8, d_model=512,
                              n_heads=8, n_kv_heads=2, head_dim=64, d_ff=1024,
                              dtype="float32")
    batch = torch.as_tensor(prompts(5, 4, 16, cfg.vocab))

    def logits(tree):
        params = weights.from_jax_tree(cfg, tree, device="cpu")
        return build(cfg).prefill(params, {"tokens": batch})[0]

    spread = {}
    for rule in ("port", "jax"):
        tree = weights.random_tree(cfg, np.random.default_rng(0))
        if rule == "jax":  # rescale to the JAX package's fan-in
            a = tree["blocks"][0]["attn"]
            for n in ("wq", "wk", "wv"):
                a[n] *= np.float32(np.sqrt(cfg.d_model / a[n].shape[2]))
            a["wo"] *= np.float32(np.sqrt(cfg.n_heads))
        tok = tree["embed"]["tok"]
        noise = np.random.default_rng(2).standard_normal(tok.shape)
        moved = dict(tree, embed={"tok": (tok * (1 + 1e-7 * noise)).astype(
            np.float32)})
        spread[rule] = float((logits(tree) - logits(moved)).abs().max())
    assert spread["port"] < 1e-4
    assert spread["jax"] > 100 * spread["port"]
