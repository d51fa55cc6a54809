"""The decoder-only model families of the port against the JAX package's,
on the CPU: each new config's smoke model (MoE: grok-1, kimi-k2; the
Mamba hybrid: jamba; RWKV6; the M-RoPE VLM backbone on embedding inputs:
qwen2-vl; dense: olmo-1b, qwen1.5-4b, qwen2-0.5b), in f32 with
``attn_impl="xla"`` in both packages, the same weights carried across by
``weights.from_jax_tree`` from one numpy tree.

Tolerances, on max |port - jax| over max(1, max |jax|):

* ``F32_TOL`` = 1e-5: the same f32 arithmetic in another order (the dense,
  MoE and VLM models; MoE routing is exact, ``test_torch_moe.py``);
* ``SCAN_TOL`` (1e-5 absolute + 1e-5 relative, elementwise) where a Mamba
  or RWKV scan is on the path: the port composes the scan's affine maps
  in log-depth steps, the JAX package by ``associative_scan``, in another
  order.

JAX runs each model under ``jax.jit`` once per entry point (prefill,
decode, loss), one batch per arch, so the file compiles few programs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import ParamSpec as JSpec  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import batch_specs, build, weights  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.rwkv import RWKVState  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402

#: the configs this slice ports (whisper-medium waits)
NEW_ARCHS = ("grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "olmo-1b",
             "qwen1.5-4b", "qwen2-0.5b", "qwen2-vl-72b", "rwkv6-7b")
F32_TOL = 1e-5
SCAN_TOL = (1e-5, 1e-5)
B, S, STEPS = 2, 12, 8


def configs(arch):
    jc = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    return jc, tc


def has_scan(cfg) -> bool:
    return any(m in ("mamba", "rwkv") for m, _ in ttf.layer_kinds(cfg))


def close(got, want, scan: bool) -> float:
    """The error in units of the tolerance (<= 1 passes)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scan:
        lim = SCAN_TOL[0] + SCAN_TOL[1] * np.abs(want)
        return float(np.max(np.abs(got - want) / lim))
    err = np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want))))
    return float(err / F32_TOL)


def inputs(cfg, seed: int):
    """The arch's prefill batch (``batch_specs`` shapes) and STEPS decode
    inputs, from numpy: token ids, or embeddings with M-RoPE's (3, B, S)
    positions whose t / h / w rows differ."""
    rng = np.random.default_rng(seed)
    spec = batch_specs(cfg, tbase.ShapeConfig("t", S, B, "prefill"))
    n = S + STEPS
    batch = {}
    if "embeds" in spec:
        batch["embeds"] = rng.standard_normal((B, n, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(3, cfg.vocab, (B, n)).astype(np.int32)
    if "positions" in spec:
        assert spec["positions"][0] == (3, B, S)
        t = np.arange(n)
        batch["positions"] = np.stack([
            np.broadcast_to(t, (B, n)), np.broadcast_to(t // 3, (B, n)),
            np.broadcast_to(t % 5 + 2 * np.arange(B)[:, None], (B, n))
        ]).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    batch["labels"][0, :3] = -100
    return batch


def prefix(batch, a, b):
    out = {}
    for k, v in batch.items():
        out[k] = v[:, :, a:b] if k == "positions" else v[:, a:b]
    return out


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_run(request):
    """For one arch: the numpy weights, the inputs, and the JAX package's
    prefill, STEPS decode steps and loss on them."""
    arch = request.param
    jc, tc = configs(arch)
    tree = weights.random_tree(tc, np.random.default_rng(7))
    batch = inputs(tc, 11)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    opts = jtf.FwdOpts(attn_impl="xla")
    pre = jax.jit(lambda p, b: jtf.prefill(p, jc, b, opts, pad_to=S + STEPS))
    dec = jax.jit(lambda p, t, s, pos: jtf.decode_step(p, jc, t, s, pos))
    jb = {k: jnp.asarray(v) for k, v in prefix(batch, 0, S).items()
          if k != "labels"}
    logits, state = pre(jparams, jb)
    steps = [(np.asarray(logits), state)]
    for t in range(STEPS):
        step = prefix(batch, S + t, S + t + 1)
        tok = step.get("embeds", step.get("tokens"))
        logits, state = dec(jparams, jnp.asarray(tok), state,
                            (jnp.asarray(step["positions"])
                             if "positions" in step else None))
        steps.append((np.asarray(logits), state))
    lb = {k: jnp.asarray(v) for k, v in prefix(batch, 0, S).items()}
    loss, metrics = jax.jit(lambda p, b: jtf.loss_fn(p, jc, b, opts))(
        jparams, lb)
    return {"arch": arch, "jc": jc, "tc": tc, "tree": tree, "batch": batch,
            "steps": steps, "loss": (float(loss), {
                k: float(v) for k, v in metrics.items()})}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def check_state(tc, got: list, want: list, scan: bool) -> None:
    """The port's per-layer decode state against the JAX package's
    stacked one (layer l: pattern position l % period, group l //
    period)."""
    period, _ = ttf.pattern(tc)
    for l, c in enumerate(got):
        w = jax.tree_util.tree_map(lambda a: np.asarray(a)[l // period],
                                   tuple(want[l % period]))
        if isinstance(c, KVCache):
            pairs = [(c.k, w[0]), (c.v, w[1])]
        elif isinstance(c, SSMState):
            pairs = [(c.h, w[0]), (c.conv, w[1])]
        else:
            assert isinstance(c, RWKVState)
            pairs = [(c.s, w[0]), (c.shift_t, w[1]), (c.shift_c, w[2])]
        for g, x in pairs:
            assert close(g.numpy(), x, scan) <= 1, (l, type(c).__name__)


def test_prefill_and_decode_match_jax(arch_run):
    """Prefill logits and every layer's state, then STEPS decode steps
    fed the same tokens (or embeddings and M-RoPE positions): logits and
    states within the tolerance."""
    tc, batch = arch_run["tc"], arch_run["batch"]
    scan = has_scan(tc)
    params = weights.from_jax_tree(tc, arch_run["tree"], device="cpu")
    bundle = build(tc)
    tb = torch_batch(prefix(batch, 0, S))
    tb.pop("labels")
    logits, state = bundle.prefill(params, tb,
                                   ttf.FwdOpts(attn_impl="xla"),
                                   pad_to=S + STEPS)
    want, jstate = arch_run["steps"][0]
    assert logits.shape == (B, 1, tc.vocab) and logits.dtype == torch.float32
    assert close(logits.numpy(), want, scan) <= 1
    assert (state.pos, state.cache_len) == (int(jstate.pos),
                                            int(jstate.cache_len))
    check_state(tc, state.caches, jstate.caches, scan)
    for t in range(STEPS):
        step = torch_batch(prefix(batch, S + t, S + t + 1))
        tok = step.get("embeds", step.get("tokens"))
        logits, state = bundle.decode(params, tok, state,
                                      step.get("positions"))
        want, jstate = arch_run["steps"][t + 1]
        assert close(logits.numpy(), want, scan) <= 1, t
    check_state(tc, state.caches, jstate.caches, scan)
    assert (state.pos, state.cache_len) == (int(jstate.pos),
                                            int(jstate.cache_len))


def test_loss_and_moe_aux_match_jax(arch_run):
    """``loss_fn`` (cross entropy, z-loss and the MoE aux loss, labels
    with masked entries) on the prompt, against the JAX package's."""
    tc = arch_run["tc"]
    params = weights.from_jax_tree(tc, arch_run["tree"], device="cpu")
    loss, metrics = build(tc).loss(params, torch_batch(
        prefix(arch_run["batch"], 0, S)), ttf.FwdOpts(attn_impl="xla"))
    jloss, jm = arch_run["loss"]
    assert abs(float(loss) - jloss) <= F32_TOL * max(1.0, abs(jloss))
    for k in ("ce", "z_loss", "moe_aux", "tokens"):
        assert abs(float(metrics[k]) - jm[k]) <= F32_TOL * max(
            1.0, abs(jm[k])), k
    if tc.n_experts:
        assert float(metrics["moe_aux"]) > 0
    else:
        assert float(metrics["moe_aux"]) == 0


def test_gradients_flow_through_every_layer_kind(arch_run):
    """Every parameter of the smoke model gets a finite gradient from
    ``loss_fn`` (attention, Mamba, RWKV, MoE and their norms), and the
    weights round-trip through the JAX package's layout."""
    tc = arch_run["tc"]
    params = weights.from_jax_tree(tc, arch_run["tree"], device="cpu")
    leaves = [t for t in _tensors(params)
              # an embeddings model reads no token table (its head is
              # untied)
              if not (tc.input_mode == "embeddings"
                      and t is params["embed"]["tok"])]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = build(tc).loss(params, torch_batch(
        prefix(arch_run["batch"], 0, S)), ttf.FwdOpts(attn_impl="xla"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    back = weights.to_jax_tree(tc, params)
    same = jax.tree_util.tree_map(np.array_equal, back, arch_run["tree"])
    assert all(jax.tree_util.tree_leaves(same))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        for v in tree:
            yield from _tensors(v)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_jax_field_for_field(arch):
    """CONFIG and SMOKE of every new arch equal the JAX package's, field
    for field, and the port's parameter tree has the JAX package's
    leaves and shapes (the pattern's blocks stacked over groups)."""
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tbase, get)(arch), getattr(jbase, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    _, tc = configs(arch)
    want = jax.tree_util.tree_map(
        lambda s: s.shape, jmodel.build(configs(arch)[0]).spec,
        is_leaf=lambda x: isinstance(x, JSpec))
    got = jax.tree_util.tree_map(lambda a: a.shape, weights.random_tree(
        tc, np.random.default_rng(0)))
    assert got == want


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_specs_match_jax(arch, shape):
    cfg = tbase.get_config(arch)
    got = batch_specs(cfg, tbase.SHAPES[shape])
    want = jmodel.batch_specs(jbase.get_config(arch), jbase.SHAPES[shape])
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_whisper_still_raises_naming_the_roadmap():
    """Whisper builds since it was ported (the name is kept from when it
    raised): every assigned architecture has a config, whisper-medium's
    field for field the JAX package's, and ``build`` / ``batch_specs``
    take the encoder-decoder family, with the audio frames beside the
    tokens."""
    assert set(tbase.PORTED) == set(tbase.ARCH_IDS)
    for get in ("get_config", "get_smoke_config"):
        got = getattr(tbase, get)("whisper-medium")
        want = getattr(jbase, get)("whisper-medium")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = tbase.get_config("whisper-medium")
    assert type(build(cfg)).__name__ == "EncDecBundle"
    assert batch_specs(cfg, tbase.SHAPES["train_4k"]) == {
        "enc_embeds": ((256, 1500, 1024), torch.bfloat16),
        "tokens": ((256, 4096), torch.int32),
        "labels": ((256, 4096), torch.int32)}
    with pytest.raises(ValueError, match="family"):
        build(dataclasses.replace(cfg, family="nope"))


def test_scheduler_serves_jamba_as_jax_does():
    """Six requests through the Scheduler's buckets (16, 32, 64), f32 and
    ``xla`` in both packages: the same greedy ids per request, the Mamba,
    MoE and attention states carried by the engine."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro.serve.engine import ServeEngine as JEngine
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.configs import RunConfig
    from repro_torch.serve import Scheduler, ServeConfig, ServeEngine
    jc, tc = configs("jamba-v0.1-52b")
    tree = weights.random_tree(tc, np.random.default_rng(7))
    params = weights.from_jax_tree(tc, tree, device="cpu")
    rng = np.random.default_rng(4)
    reqs = [(f"r{i}", rng.integers(3, tc.vocab, size=int(n)))
            for i, n in enumerate([4, 9, 17, 30, 33, 47])]
    jeng = JEngine(jc, jax.tree_util.tree_map(jnp.asarray, tree),
                   JServeConfig(max_new_tokens=5),
                   run=JRunConfig(attn_impl="xla"))
    teng = ServeEngine(tc, params, ServeConfig(max_new_tokens=5),
                       run=RunConfig(attn_impl="xla"))
    js, ts = JScheduler(jeng, max_batch=8), Scheduler(teng, max_batch=8)
    for rid, tok in reqs:
        js.submit(rid, tok)
        ts.submit(rid, tok)
    assert ts.run_until_drained()["n_done"] == js.run_until_drained()[
        "n_done"] == 6
    for rid, _ in reqs:
        assert np.array_equal(ts.done[rid].output, js.done[rid].output), rid


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_carries_every_state_kind(arch):
    """ServeEngine.generate's greedy ids equal a prefill and decode loop
    through ModelBundle on the same weights: KV rings, Mamba and RWKV
    states across steps. The launcher serves the arch on the CPU. An
    embeddings model (qwen2-vl) is refused by both, naming ROADMAP, as
    the JAX package's engine takes tokens only."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeConfig, ServeEngine
    _, tc = configs(arch)
    params = weights.from_jax_tree(
        tc, weights.random_tree(tc, np.random.default_rng(3)), device="cpu")
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "2"]
    if tc.input_mode == "embeddings":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeEngine(tc, params)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            launch_serve.main(argv)
        return
    prompts = np.random.default_rng(5).integers(3, tc.vocab, (3, 16)).astype(
        np.int32)
    got = ServeEngine(tc, params, ServeConfig(max_new_tokens=6),
                      run=RunConfig(attn_impl="xla")).generate(prompts)
    bundle = build(tc)
    opts = ttf.FwdOpts(attn_impl="xla")
    logits, state = bundle.prefill(
        params, {"tokens": torch.as_tensor(prompts, dtype=torch.int64)},
        opts, pad_to=22)
    want = []
    for _ in range(6):
        tok = logits[:, 0].argmax(-1, keepdim=True)
        want.append(tok)
        logits, state = bundle.decode(params, tok, state)
    assert np.array_equal(got, torch.cat(want, 1).numpy())
    assert launch_serve.main(argv) == 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_caches_match_jax(arch):
    """Each layer's empty decode state has the JAX package's shapes and
    dtypes (a KV ring in the cache dtype; Mamba h f32 and its conv tail
    in the cache dtype; RWKV's wkv state f32 and its shifts in the cache
    dtype), the JAX package's stacked over the pattern's groups."""
    jc, tc = configs(arch)
    want = jtf.init_caches(jc, 3, 9, dtype=jnp.bfloat16)
    got = ttf.init_caches(tc, 3, 9, dtype=torch.bfloat16, device="cpu")
    period, groups = ttf.pattern(tc)
    assert len(got) == tc.n_layers and len(want) == period
    for l, c in enumerate(got):
        w = want[l % period]
        assert type(c).__name__ == type(w).__name__
        for g, x in zip(c, w):
            assert (groups,) + tuple(g.shape) == tuple(x.shape)
            assert str(g.dtype).split(".")[-1] == str(x.dtype)
            assert not g.any()
