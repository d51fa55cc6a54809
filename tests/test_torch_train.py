"""The port's training path against the JAX package's, on the CPU.

The 11 cases of ``tests/test_train.py`` through the port (the ones on
qwen2-0.5b and olmo-1b, which are not ported, on llama3.2-1b-smoke), then
the two packages side by side on the same numpy inputs: ``apply_updates``
and ``clip_by_global_norm``; ``loss_fn`` and every gradient leaf of
``jax.value_and_grad`` (weights carried across by
``models/weights.from_jax_tree`` / ``to_jax_tree``) for ``xla`` and
``chunked`` (the port's flash backward, its plain version here);
``make_train_step`` with gradient accumulation; and checkpoint directories
written by either package's ``CheckpointManager`` and read by the other.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.ft.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.transformer import FwdOpts as JOpts  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import RunConfig, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.ft.straggler import (CHECKPOINT_AND_REPLACE, OK,  # noqa: E402
                                      StragglerConfig, StragglerMonitor)
from repro_torch.launch.steps import (default_hyper,  # noqa: E402
                                      make_train_step)
from repro_torch.models import FwdOpts, build, weights  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.train import grad_compress, schedule  # noqa: E402
from repro_torch.train.optimizer import (OptHyper, apply_updates,  # noqa: E402
                                         clip_by_global_norm, init_state,
                                         state_specs)
from repro_torch.train.train_loop import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.tree import leaves_with_path, tree_leaves  # noqa: E402

ARCH = "llama3.2-1b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
OPT_TOL = 1e-6    # optimizer and clip: the same f32 arithmetic
# loss and gradients over max |jax leaf|: f32 sums in another order; in
# bf16 both round every product to 8 bits, at other places (the JAX
# package keeps f32 masters and f32 gradients, the port bf16 ones)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JAX_CHUNK = 8     # several chunks of the JAX scan at S 16


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


def host(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# the JAX package's test_train.py, through the port
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    h = OptHyper(name="adamw", lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                 weight_decay=0.0)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.5]])}
    s = init_state(p, h)
    new_p, s = apply_updates(h, p, g, s)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mh, vh = m / 0.1, v / 0.01
    want = 1.0 - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    assert abs(float(new_p["w"][0, 0]) - want) < 1e-5
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 1
    assert s["m"]["w"].dtype == torch.float32


def test_adamw_weight_decay_only_on_matrices():
    h = OptHyper(name="adamw", lr=0.1, weight_decay=0.5)
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    s = init_state(p, h)
    new_p, _ = apply_updates(h, p, g, s)
    assert float(new_p["w"][0, 0]) < 1.0      # decayed
    assert float(new_p["b"][0]) == 1.0        # not decayed


def test_adafactor_state_is_factored():
    h = OptHyper(name="adafactor", factored_min=4)
    specs = {"w": ParamSpec((128, 64)), "b": ParamSpec((64,))}
    st = state_specs(specs, h)
    assert st["vr"]["w"].shape == (128,)
    assert st["vc"]["w"].shape == (64,)
    assert st["vr"]["b"].shape == (64,)       # unfactored fallback
    p = {"w": torch.zeros((128, 64)), "b": torch.zeros((64,))}
    s = init_state(p, h)
    assert s["vr"]["w"].shape == (128,) and s["vc"]["w"].shape == (64,)
    assert s["vc"]["b"].shape == (1,)         # the unused stub


def test_adafactor_descends_quadratic():
    h = OptHyper(name="adafactor", lr=0.05, weight_decay=0.0, factored_min=2)
    p = {"w": torch.full((8, 8), 3.0)}
    s = init_state(p, h)
    for _ in range(50):
        g = {"w": 2 * p["w"]}
        p, s = apply_updates(h, p, g, s)
    assert float(torch.mean(torch.abs(p["w"]))) < 1.0


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 10.0) < 1e-4
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tree_leaves(clipped)))
    assert abs(float(total) - 1.0) < 1e-4


def test_warmup_cosine_shape():
    lrs = [float(schedule.warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                                        total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[5] < lrs[10]
    assert abs(lrs[10] - 1.0) < 0.01
    assert lrs[99] < 0.2
    assert float(schedule.constant(7, peak_lr=0.5)) == 0.5


def test_trainer_lr_at_matches_jax_schedule():
    from repro.train import schedule as jschedule
    tr = Trainer(get_smoke_config(ARCH), RunConfig(learning_rate=2e-3),
                 TrainerConfig(total_steps=40, warmup_steps=4), device="cpu")
    for s in range(40):
        want = float(jschedule.warmup_cosine(s, peak_lr=2e-3, warmup_steps=4,
                                             total_steps=40))
        assert abs(tr.lr_at(s) - want) <= OPT_TOL * 2e-3, s


def test_grad_compress_error_feedback_bounded():
    rng = np.random.default_rng(0)
    g = {"w": torch.as_tensor(rng.normal(size=(64, 64)), dtype=torch.float32)}
    e = grad_compress.init_error_state(g)
    acc_true = np.zeros((64, 64))
    acc_seen = np.zeros((64, 64))
    for i in range(20):
        g = {"w": torch.as_tensor(rng.normal(size=(64, 64)),
                                  dtype=torch.float32)}
        deq, e = grad_compress.compress_grads(g, e)
        acc_true += g["w"].numpy()
        acc_seen += deq["w"].numpy()
    # error feedback: cumulative error stays bounded by one quantization step
    resid = np.abs(acc_true - acc_seen).max()
    scale = np.abs(acc_true).max() / 127
    assert resid < 8 * scale


def smoke_pipe(cfg, n_tok: int, take: int):
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab, size=n_tok).astype(np.int32)
    return TokenPipeline(np.tile(toks[:take], 4),
                         DataConfig(seq_len=32, global_batch=4))


def test_trainer_loss_decreases_and_restores():
    cfg = get_smoke_config(ARCH)
    pipe = smoke_pipe(cfg, 5000, 1320)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, RunConfig(learning_rate=2e-3, attn_impl="xla"),
                     TrainerConfig(total_steps=14, warmup_steps=2,
                                   ckpt_every=5, ckpt_dir=d), device="cpu")
        hist = tr.run_loop(iter(pipe))
        assert hist[-1]["loss"] < hist[0]["loss"]
        steps = tr.ckpt.steps()
        assert steps == [5, 10]
        p5 = tr.ckpt.restore(5, like=tr.state["params"])
        flat = tree_leaves(p5)
        assert all(torch.isfinite(x.float()).all() for x in flat)
        assert all(a.dtype == b.dtype and a.shape == b.shape
                   for a, b in zip(flat, tree_leaves(tr.state["params"])))
        # restore-exactness: saved-at-5 equals what a fresh manager loads
        cm2 = CheckpointManager(d, device="cpu")
        p5b = cm2.restore(5, like=tr.state["params"])
        assert all(torch.equal(a, b)
                   for a, b in zip(flat, tree_leaves(p5b)))
        # and the Trainer resumes from it
        tr.restore(5)
        assert tr.step == 5 and all(torch.equal(a, b) for a, b in zip(
            flat, tree_leaves(tr.state["params"])))


def test_trainer_grad_compress_converges():
    cfg = get_smoke_config(ARCH)   # the JAX package's test takes qwen2-0.5b
    pipe = smoke_pipe(cfg, 2000, 660)
    tr = Trainer(cfg, RunConfig(learning_rate=2e-3, attn_impl="xla",
                                grad_compress=True),
                 TrainerConfig(total_steps=10, warmup_steps=2), device="cpu")
    hist = tr.run_loop(iter(pipe))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert tr.state["ef"]["layers"][0]["attn"]["wq"].dtype == torch.float32


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(StragglerConfig(window=8, min_steps=4, patience=2))
    rng = np.random.default_rng(0)
    verdicts = {}
    for step in range(12):
        for h in range(8):
            t = 1.0 + rng.normal() * 0.01 + (3.0 if h == 5 else 0.0)
            mon.record(f"host{h}", t)
        verdicts = mon.evaluate()
    assert verdicts["host5"] == CHECKPOINT_AND_REPLACE
    assert all(v == OK for h, v in verdicts.items() if h != "host5")
    assert mon.worst()[0] == "host5"


def test_microbatch_accumulation_matches_full_batch():
    cfg = get_smoke_config(ARCH)   # the JAX package's test takes olmo-1b
    run_full = RunConfig(attn_impl="xla", learning_rate=1e-3)
    run_mb = RunConfig(attn_impl="xla", learning_rate=1e-3, microbatch=2)
    params = build(cfg).init(0, device="cpu")
    hyper = default_hyper(cfg, run_full)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                       dtype=torch.int32),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                       dtype=torch.int32)}
    s1 = {"params": params, "opt": init_state(params, hyper)}
    s2 = {"params": params, "opt": init_state(params, hyper)}
    ns1, m1 = make_train_step(cfg, run_full, hyper)(s1, batch)
    ns2, m2 = make_train_step(cfg, run_mb, hyper)(s2, batch)
    # losses agree; grads (hence params) agree to accumulation tolerance
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in
               zip(tree_leaves(ns1["params"]), tree_leaves(ns2["params"])))
    assert diff < 5e-2
    # the step is functional: the state it was given is untouched
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(s1["params"])))
    assert int(s1["opt"]["step"]) == 0 and int(ns1["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------

OPT_TREE = {"w": (8, 160), "e": (3, 130, 140), "b": (160,)}


def opt_inputs(dtype, seed=3):
    """Parameters and three steps of gradients, as numpy f32 holding
    values of ``dtype`` (both packages start from the same rounding)."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return {k: np.asarray(jnp.asarray(rng.normal(size=s) * scale,
                                          dtype), np.float32)
                for k, s in OPT_TREE.items()}

    return draw(1.0), [draw(3.0) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_updates_match_jax(name, dtype):
    """Three updates of the same parameters by the same gradients
    (factored and unfactored Adafactor leaves, decayed and undecayed AdamW
    leaves): the f32 state, and f32 parameters, within OPT_TOL relative.
    bf16 parameters round as the JAX package's do (the update cast to bf16
    before it is scaled, lr as bf16), so they are equal but where the f32
    update itself differs in its last bit and that straddles a bf16
    rounding boundary: AdamW's bias correction 1 - b2 ** step is XLA's f32
    pow, one f32 ulp from torch's at some steps (0.999 ** 3). In those
    elements, under 0.1%, the update rounds to a neighbouring bf16 value
    (one bf16 ulp of |upd| < 2, times lr), and the parameter may round to
    a neighbour of its own: they are at most that far apart."""
    kw = dict(name=name, lr=1e-2, weight_decay=0.1, factored_min=128)
    th, jh = OptHyper(**kw), jopt.OptHyper(**kw)
    p0, gs = opt_inputs(dtype)
    tdt = getattr(torch, dtype)
    tp = {k: torch.as_tensor(v).to(tdt) for k, v in p0.items()}
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    ts, js = init_state(tp, th), jopt.init_state(jp, jh)
    for step, g in enumerate(gs):
        tp, ts = apply_updates(th, tp, {k: torch.as_tensor(v).to(tdt)
                                        for k, v in g.items()}, ts)
        jp, js = jopt.apply_updates(jh, jp, {k: jnp.asarray(v, dtype)
                                             for k, v in g.items()}, js)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        for k in p0:
            assert tp[k].dtype == tdt
            got, want = host(tp[k]), np.asarray(jp[k], np.float32)
            if dtype == "float32":
                close(got, want, OPT_TOL, f"step {step} {k}")
            else:
                off = got != want
                assert off.mean() < 1e-3, (step, k, off.sum())
                assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
                        + kw["lr"] * 2.0 ** -6).all(), (step, k)
                # the next step starts from the same parameters
                tp[k] = torch.as_tensor(want).to(tdt)
            for sk in ts:
                if sk != "step":
                    assert ts[sk][k].dtype == torch.float32
                    close(host(ts[sk][k]), np.asarray(js[sk][k]), OPT_TOL,
                          f"step {step} {sk}[{k}]")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [10.0, 1e4])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    """The global norm and the clipped gradients, clipping (max_norm 10)
    and not (1e4). f32: within OPT_TOL relative. bf16 gradients: the JAX
    package's f32 sum of their squares lands 1.8e-6 from the f64 sum here
    (the port's within 1e-7), so each norm is held to the f64 one, the
    JAX package's within 1e-5; the clipped values, each one rounding of
    g * scale to bf16, within one bf16 ulp (2^-8 of the value) of JAX's."""
    _, gs = opt_inputs(dtype)
    tdt = getattr(torch, dtype)
    tg, gn = clip_by_global_norm({k: torch.as_tensor(v).to(tdt)
                                  for k, v in gs[0].items()}, max_norm)
    jg, jgn = jopt.clip_by_global_norm({k: jnp.asarray(v, dtype)
                                        for k, v in gs[0].items()}, max_norm)
    exact = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                        for v in gs[0].values()))
    assert gn.dtype == torch.float32 and gn.ndim == 0
    if dtype == "float32":
        close(float(gn), float(jgn), OPT_TOL, "norm")
    else:
        close(float(gn), exact, OPT_TOL, "port norm")
        close(float(jgn), exact, 1e-5, "jax norm")
    for k in gs[0]:
        assert tg[k].dtype == tdt
        got, want = host(tg[k]), np.asarray(jg[k], np.float32)
        if dtype == "float32" or max_norm > exact:
            close(got, want, OPT_TOL, k)
        else:
            assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)).all(), k


def configs(dtype):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def tree():
    """Smoke-model weights in the JAX package's layout, f32, from a numpy
    generator (the port's init rules; see models/weights.py)."""
    return weights.random_tree(get_smoke_config(ARCH),
                               np.random.default_rng(0))


def lm_batch(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -100                      # masked labels
    return {"tokens": rng.integers(3, cfg.vocab, (b, s)).astype(np.int32),
            "labels": labels}


def jax_value_and_grad(jc, tree, batch, impl):
    opts = JOpts(attn_impl=impl, attn_chunk=JAX_CHUNK)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(lambda p: jbuild(jc).loss(p, jb, opts),
                              has_aux=True)(jparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_loss_and_every_gradient_match_jax(tree, impl, dtype):
    jc, tc = configs(dtype)
    batch = lm_batch(tc)
    (jloss, jm), jgrads = jax_value_and_grad(jc, tree, batch, impl)
    params = weights.from_jax_tree(tc, tree, device="cpu")
    live = [p.requires_grad_() for p in tree_leaves(params)]
    loss, m = build(tc).loss(params, {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                             FwdOpts(attn_impl=impl))
    loss.backward()
    tol = GRAD_TOL[dtype]
    close(float(loss.detach()), float(jloss), tol, "loss")
    for k in ("ce", "z_loss", "moe_aux", "tokens"):
        close(float(m[k]), float(jm[k]), tol, k)
    assert float(m["tokens"]) == 32 - 3
    grads = weights.to_jax_tree(tc, _grad_tree(params))
    jflat = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                         jgrads)))
    tflat = dict(leaves_with_path(grads))
    assert tflat.keys() == jflat.keys() and len(live) == 20
    for path in jflat:
        close(tflat[path], jflat[path], tol, path)


def _grad_tree(params):
    def g(t):
        if isinstance(t, dict):
            return {k: g(v) for k, v in t.items()}
        if isinstance(t, list):
            return [g(v) for v in t]
        return t.grad
    return g(params)


def test_remat_policies_give_the_same_gradients(tree):
    """nothing_saveable, dots and none recompute or keep, but compute the
    same numbers: the gradients are equal bit for bit (f32, chunked)."""
    _, tc = configs("float32")
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(tc).items()}
    out = []
    for remat in ("none", "nothing_saveable", "dots"):
        params = weights.from_jax_tree(tc, tree, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_()
        loss, _ = build(tc).loss(params, batch,
                                 FwdOpts(attn_impl="chunked", remat=remat))
        loss.backward()
        out.append([p.grad for p in tree_leaves(params)])
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


def test_microbatch_train_step_matches_jax(tree):
    """make_train_step with microbatch=2 against the JAX package's on the
    same weights and batch (f32, xla): loss, gradient norm and the
    accumulated, clipped gradients (AdamW's first moment over 1 - b1)
    within GRAD_TOL. The updated parameters: AdamW's first step is lr * g
    / (|g| + 1e-8), about lr * sign(g): a gradient error e (GRAD_TOL of
    the leaf's largest gradient) moves it by up to lr * e / (|g| + 1e-8),
    which is large only where g is near 0. The parameters are held to
    twice that, plus 1e-6."""
    jc, tc = configs("float32")
    batch = lm_batch(tc, b=4)
    jrun = JRunConfig(attn_impl="xla", learning_rate=1e-3, microbatch=2)
    run = RunConfig(attn_impl="xla", learning_rate=1e-3, microbatch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jh = jsteps.default_hyper(jc, jrun)
    jstate = {"params": jparams, "opt": jopt.init_state(jparams, jh)}
    jnew, jm = jax.jit(jsteps.make_train_step(jc, jrun, jh))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = weights.from_jax_tree(tc, tree, device="cpu")
    h = default_hyper(tc, run)
    new, m = make_train_step(tc, run, h)(
        {"params": params, "opt": init_state(params, h)},
        {k: torch.as_tensor(v) for k, v in batch.items()})
    tol = GRAD_TOL["float32"]
    close(float(m["loss"]), float(jm["loss"]), tol, "loss")
    close(float(m["grad_norm"]), float(jm["grad_norm"]), tol, "grad_norm")
    def flat(t_tree, j_tree):
        return (dict(leaves_with_path(weights.to_jax_tree(tc, t_tree))),
                dict(leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                             j_tree))))

    m_t, m_j = flat(new["opt"]["m"], jnew["opt"]["m"])
    p_t, p_j = flat(new["params"], jnew["params"])
    assert m_t.keys() == m_j.keys() == p_t.keys() == p_j.keys()
    for path in m_j:
        close(m_t[path], m_j[path], tol, path)
        g = np.abs(m_j[path]) / (1 - 0.9)      # the clipped gradient
        bound = 1e-6 + 2 * 1e-3 * tol * g.max() / (g + 1e-8)
        assert (np.abs(p_t[path] - p_j[path]) <= bound).all(), path


def ckpt_trees(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.normal(size=(3, 700)).astype(np.float32),
                        "b": rng.normal(size=(7,)).astype(np.float32)}
                       for _ in range(2)],
            "emb": rng.normal(size=(2100,)).astype(np.float32),
            "h": rng.normal(size=(5, 4)).astype(np.float32)}


def test_checkpoint_directories_open_in_both_packages():
    """A directory the port's CheckpointManager writes (device="cpu",
    asynchronous saves) opens in the JAX package's, and one the JAX
    package writes opens in the port's, with equal leaves at every step;
    bf16 leaves keep their dtype across."""
    steps = {3: ckpt_trees(0), 7: ckpt_trees(1)}
    steps[7]["layers"][0]["w"] = steps[3]["layers"][0]["w"]  # unchanged rows
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(os.path.join(d, "port"), device="cpu")
        for t, tr in steps.items():
            tt = {"layers": [{k: torch.as_tensor(v) for k, v in lay.items()}
                             for lay in tr["layers"]],
                  "emb": torch.as_tensor(tr["emb"]),
                  "h": torch.as_tensor(tr["h"]).to(torch.bfloat16)}
            cm.save(t, tt)
        assert cm.steps() == [3, 7] and cm.stats()["versions"] == 2
        jc = JCkpt(os.path.join(d, "port"))
        assert jc.steps() == [3, 7]
        for t, tr in steps.items():
            got = jc.restore(t)
            want = dict(leaves_with_path(tr))
            assert got.keys() == want.keys()
            for path, w in want.items():
                if path == "['h']":
                    assert str(got[path].dtype) == "bfloat16"
                    w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
                np.testing.assert_array_equal(
                    np.asarray(got[path], np.float32), w, err_msg=path)

        jm = JCkpt(os.path.join(d, "jax"), async_save=False)
        for t, tr in steps.items():
            jm.save(t, jax.tree_util.tree_map(jnp.asarray, tr))
        pm = CheckpointManager(os.path.join(d, "jax"), device="cpu")
        assert pm.steps() == [3, 7]
        for t, tr in steps.items():
            like = jax.tree_util.tree_map(torch.as_tensor, tr)
            got = dict(leaves_with_path(pm.restore(t, like=like)))
            for path, w in leaves_with_path(tr):
                assert got[path].dtype == torch.float32
                np.testing.assert_array_equal(got[path].numpy(), w,
                                              err_msg=path)
        assert pm.stats() == jm.stats()


def test_train_launcher_runs_on_cpu():
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
             "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
             "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", d],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        assert out.returncode == 0, out.stderr[-2000:]
        assert "done: 3 steps" in out.stdout
        assert os.path.exists(os.path.join(d, "meta.json"))


@pytest.mark.parametrize("rule", ["adamw", "adafactor", "compress"])
def test_stacked_layers_rules_match_jax(tree, rule):
    """The JAX package holds every layer of a parameter in one stacked
    leaf, and what it computes per leaf sees the stack: weight decay
    where ``ndim >= 2`` (norm scales too), Adafactor's factoring and RMS
    clip, the int8 compression's scale. On the smoke model's tree (f32,
    factored_min 32 so its matrices factor) one update, or one round of
    compression, matches the JAX package's on its stacked tree within
    OPT_TOL."""
    _, tc = configs("float32")
    rng = np.random.default_rng(11)
    grads_np = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    params = weights.from_jax_tree(tc, tree, device="cpu")
    grads = weights.from_jax_tree(tc, grads_np, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jg = jax.tree_util.tree_map(jnp.asarray, grads_np)
    if rule == "compress":
        from repro.train import grad_compress as jgc
        got, err = grad_compress.compress_grads(
            grads, grad_compress.init_error_state(grads))
        want, jerr = jgc.compress_grads(jg, jgc.init_error_state(jg))
        pairs = ((got, want), (err, jerr))
    else:
        kw = dict(name=rule, lr=1e-2, weight_decay=0.1, factored_min=32)
        h, jh = OptHyper(**kw), jopt.OptHyper(**kw)
        new, _ = apply_updates(h, params, grads, init_state(params, h))
        jnew, _ = jopt.apply_updates(jh, jp, jg, jopt.init_state(jp, jh))
        pairs = ((new, jnew),)
    for t_tree, j_tree in pairs:
        got = dict(leaves_with_path(weights.to_jax_tree(tc, t_tree)))
        want = dict(leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                            j_tree)))
        assert got.keys() == want.keys()
        for path in want:
            close(got[path], want[path], OPT_TOL, path)
