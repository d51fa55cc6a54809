"""The port's sharded paths on 4 gloo ranks on the CPU, against the JAX
package's unsharded answers on the same numpy inputs.

One run of 4 processes (``tests/_torch_dist_ranks.py``, a ``FileStore``
in the test's temporary directory, no TCP port) does every check; the
tests below read its outputs:

* llama3.2-1b-smoke (f32): 2 sharded train steps (AdamW, the flash
  kernel's plain version, ``dots`` remat) on a (data 2, model 2) mesh
  against the JAX package's unsharded ``make_train_step`` on the same
  weights (losses within ``TOL``, gradient norms within ``NORM_TOL``,
  every parameter within ``PARAM_TOL``) and against the port's own
  unsharded steps (all within ``TOL``);
* qwen2-0.5b-smoke (f32): the loss on (2, 2), where its 7 heads do not
  divide the model axis (the sequence-parallel branch), against the JAX
  package's unsharded loss; its gradients with per-layer remat, the
  backward on a thread of its own, against the port's unsharded ones;
  and so the smoke losses of jamba (Mamba and
  MoE), rwkv6 (the WKV recurrence per rank) and whisper-medium;
* ``apply_moe_sharded`` in EP mode (kimi-k2-smoke's 8 experts on (2, 2))
  and TP mode (grok-1-smoke with 2 experts on (1, 4)) against the JAX
  package's ``_moe_local`` run for each (data shard, model peer) and
  summed over the peers;
* ``podwise_mean`` of ``compress_grads``'s output on a (pod 2, data 2)
  mesh against the JAX package's ``compress_grads`` and mean, and within
  the JAX test's int8 bound of the true mean;
* elastic restore: the sharded parameters saved from (2, 2) and restored
  by ``remesh`` onto 2 ranks, bit for bit;
* the training launcher with ``REPRO_DISTRIBUTED`` on the 4 ranks (a
  ("data",) mesh, each rank its quarter of each batch) against the same
  launcher in one process on the whole batch, as it is and with int8
  gradient compression: the losses and gradient norms it logs, and the
  parameters of its checkpoint.
"""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.moe import _moe_local  # noqa: E402
from repro.models.transformer import FwdOpts as JOpts  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.ft.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = os.path.join(os.path.dirname(__file__), "_torch_dist_ranks.py")
#: f32 agreement of a sharded result with the JAX package's unsharded one
#: (DTensor sums partial products in another order than XLA), and with the
#: port's own unsharded one
TOL = 2e-5
#: a gradient norm against the JAX package's: the port's flash backward
#: and the JAX package's differentiated XLA scan differ by 4.5e-5 relative
#: in llama3.2-1b-smoke's first norm unsharded already (the sharded step
#: matches the port's unsharded one within TOL)
NORM_TOL = 1e-4
#: a parameter after 2 AdamW steps against the JAX package's, absolute:
#: that gradient difference, normalized by Adam per entry (2.2e-5 in wq
#: on these weights; the sharded step's parameters are within 7e-6 of the
#: port's unsharded ones)
PARAM_TOL = 5e-5
WORLD = 4
#: the training launcher's run: llama3.2-1b-smoke (bf16), 2 AdamW steps of
#: a 4-row global batch, a checkpoint after the second
LAUNCH_LR = 1e-2
LAUNCH_ARGV = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
               "--steps", "2", "--batch", "4", "--seq", "16",
               "--lr", str(LAUNCH_LR), "--ckpt-every", "2", "--seed", "0"]
#: the launcher's runs: as it is, and with int8 gradient compression
LAUNCH_RUNS = {"plain": LAUNCH_ARGV,
               "grad_compress": LAUNCH_ARGV + ["--grad-compress"]}
#: the families whose smoke losses run on (2, 2) beside llama and qwen2
FAMILIES = ("jamba-v0.1-52b", "rwkv6-7b", "whisper-medium")


sys.path.insert(0, os.path.dirname(__file__))
from _torch_dist_ranks import StepLog  # noqa: E402


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def np_init(jcfg, seed: int):
    """The JAX package's parameter tree of ``jcfg`` drawn by numpy from
    ``seed`` with its init rules (``init_param``'s std): its own seeded
    init folds Python's salted ``hash`` of each path, so it differs from
    one process to the next."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = {"embed": 0.02, "small": 0.01}.get(
            s.init, 1.0 / np.sqrt(max(fan_in, 1))) * s.scale
        return (rng.normal(0, 1, s.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map(
        draw, jbuild(jcfg).spec, is_leaf=lambda x: hasattr(x, "axes"))


def lm_batch(seed: int, vocab: int, b: int = 4, s: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def moe_inputs(jcfg, seed: int):
    rng = np.random.default_rng(seed)
    d, e, f = jcfg.d_model, jcfg.n_experts, jcfg.d_ff_expert
    p = {"router": rng.normal(0, 0.5, (d, e)),
         "wi": rng.normal(0, d ** -0.5, (e, d, f)),
         "wo": rng.normal(0, f ** -0.5, (e, f, d))}
    if jcfg.mlp_gated:
        p["wg"] = rng.normal(0, d ** -0.5, (e, d, f))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (4, 8, d)).astype(np.float32)
    return p, x


def jax_moe_sharded(jcfg, p, x, dp: int, n_model: int, ep: bool):
    """The JAX package's shard_map body, unsharded: each data shard's
    tokens through ``_moe_local`` for every model peer's weights, summed
    over the peers; the aux loss averaged over the data shards."""
    act = jax.nn.silu if jcfg.act == "silu" else jax.nn.gelu
    b, s, d = x.shape
    e, f = jcfg.n_experts, jcfg.d_ff_expert
    t_loc = (b // dp) * s
    cap = int(max(1, round(t_loc * jcfg.top_k / e * jcfg.capacity_factor)))
    e_local = e // n_model if ep else e
    fl = f // n_model
    ys, auxes = [], []
    for i in range(dp):
        xf = jnp.asarray(x[i * b // dp:(i + 1) * b // dp].reshape(-1, d))
        y = 0
        for r in range(n_model):
            if ep:
                sl = slice(r * e_local, (r + 1) * e_local)
                wi, wo = p["wi"][sl], p["wo"][sl]
                wg = p["wg"][sl] if "wg" in p else None
            else:
                sl = slice(r * fl, (r + 1) * fl)
                wi, wo = p["wi"][:, :, sl], p["wo"][:, sl]
                wg = p["wg"][:, :, sl] if "wg" in p else None
            y_r, aux = _moe_local(
                xf, jnp.asarray(p["router"]), jnp.asarray(wi),
                None if wg is None else jnp.asarray(wg), jnp.asarray(wo),
                jcfg, e_lo=r * e_local if ep else 0, e_local=e_local,
                cap=cap, axis=None, act=act)
            y = y + y_r
        ys.append(np.asarray(y).reshape(b // dp, s, d))
        auxes.append(float(aux))
    return np.concatenate(ys), float(np.mean(auxes)), cap


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """The JAX package's answers, then one 4-rank run of the port."""
    root = str(tmp_path_factory.mktemp("torch_dist"))
    inp: dict = {}
    want: dict = {}

    # llama3.2-1b-smoke: 2 unsharded JAX train steps
    jcfg = f32(jax_smoke("llama3.2-1b"))
    params = np_init(jcfg, 0)
    inp["llama_params"] = params
    batch = lm_batch(0, jcfg.vocab)
    inp["llama_batch"] = batch
    run = JRunConfig(attn_impl="chunked", remat="dots")
    hyper = jsteps.default_hyper(jcfg, run)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = {"params": params, "opt": jopt.init_state(params, hyper)}
    step = jax.jit(jsteps.make_train_step(jcfg, run, hyper))
    losses, norms = [], []
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        state, m = step(state, jbatch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want["llama"] = {"losses": losses, "grad_norms": norms,
                     "params": np_tree(state["params"])}

    # qwen2-0.5b-smoke: the unsharded loss
    qcfg = f32(jax_smoke("qwen2-0.5b"))
    qparams = np_init(qcfg, 1)
    inp["qwen_params"] = qparams
    qbatch = lm_batch(1, qcfg.vocab)
    inp["qwen_batch"] = qbatch
    loss, _ = jbuild(qcfg).loss(qparams, {k: jnp.asarray(v) for k, v in
                                          qbatch.items()},
                                JOpts(attn_impl="chunked"))
    want["qwen"] = float(loss)

    # the other families' smoke losses, unsharded
    inp["family"], want["family"] = {}, {}
    for i, arch in enumerate(FAMILIES):
        fcfg = f32(jax_smoke(arch))
        fparams = np_init(fcfg, 2 + i)
        fbatch = lm_batch(2 + i, fcfg.vocab)
        if fcfg.family == "encdec":
            fbatch["enc_embeds"] = np.random.default_rng(i).normal(
                0, 1, (4, fcfg.encoder_seq, fcfg.d_model)).astype(
                    np.float32)
        inp["family"][arch] = (fparams, fbatch)
        floss, _ = jbuild(fcfg).loss(
            fparams, {k: jnp.asarray(v) for k, v in fbatch.items()},
            JOpts(attn_impl="chunked"))
        want["family"][arch] = float(floss)

    # MoE: EP (kimi-k2-smoke, 8 experts, on (2, 2)) and TP (grok-1-smoke
    # with 2 experts, on (1, 4))
    for mode, arch, n_exp, (dp, n_model) in (
            ("ep", "kimi-k2-1t-a32b", None, (2, 2)),
            ("tp", "grok-1-314b", 2, (1, 4))):
        jc, pc = f32(jax_smoke(arch)), f32(get_smoke_config(arch))
        if n_exp is not None:
            jc = dataclasses.replace(jc, n_experts=n_exp)
            pc = dataclasses.replace(pc, n_experts=n_exp)
        p, x = moe_inputs(jc, 7)
        inp[f"moe_{mode}_cfg"] = pc
        inp[f"moe_{mode}_params"] = p
        inp[f"moe_{mode}_x"] = x
        y, aux, cap = jax_moe_sharded(jc, p, x, dp, n_model, mode == "ep")
        assert cap == capacity((x.shape[0] // dp) * x.shape[1], pc)
        want[f"moe_{mode}"] = {"y": y, "aux": aux}

    # podwise_mean: each pod's gradient, compressed, averaged over pods
    g = np.random.default_rng(3).normal(0, 1, (2, 64)).astype(np.float32)
    inp["pod_grads"] = g
    deq = [np.asarray(jgc.compress_grads(
        {"w": jnp.asarray(g[p])}, {"w": jnp.zeros(64)})[0]["w"])
        for p in range(2)]
    want["podwise"] = {"mean": np.mean(deq, axis=0), "true": g.mean(0),
                       "scale": float(np.abs(g).max()) / 127}

    # the training launcher in this process, on the whole batch
    inp["launcher_argv"] = LAUNCH_RUNS
    want["launcher"] = {}
    for name, argv in LAUNCH_RUNS.items():
        log = StepLog()
        logger = logging.getLogger("repro_torch.launch.train")
        logger.addHandler(log)
        try:
            assert train_launcher.main(argv + ["--ckpt-dir", os.path.join(
                root, f"single_ckpt_{name}")]) == 0
        finally:
            logger.removeHandler(log)
        want["launcher"][name] = log.steps

    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, RANKS, root, str(r),
                               str(WORLD)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=480)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"--- rank {r} (exit {c})\n{log[-4000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    with open(os.path.join(root, "outputs.pkl"), "rb") as f:
        got = pickle.load(f)
    return got, want


def test_sharded_train_step_matches_unsharded_jax(dist_run):
    got, want = dist_run
    g, w = got["llama"], want["llama"]
    assert g["mesh"] == (2, 2)
    # the parameters really were sharded: FSDP over data, TP over model
    assert any("Shard" in s for s in g["layouts"])
    np.testing.assert_allclose(g["losses"], w["losses"], rtol=TOL)
    np.testing.assert_allclose(g["grad_norms"], w["grad_norms"],
                               rtol=NORM_TOL)
    np.testing.assert_allclose(g["losses"], g["plain_losses"], rtol=TOL)
    np.testing.assert_allclose(g["grad_norms"], g["plain_grad_norms"],
                               rtol=TOL)
    assert g["losses"][1] < g["losses"][0]
    leaves_g = jax.tree_util.tree_leaves_with_path(g["params"])
    for name, other, tol in (("jax", w["params"], PARAM_TOL),
                             ("port", g["plain_params"], TOL)):
        leaves_w = dict((jax.tree_util.keystr(p), x) for p, x in
                        jax.tree_util.tree_leaves_with_path(other))
        assert len(leaves_g) == len(leaves_w)
        for path, x in leaves_g:
            np.testing.assert_allclose(
                x, leaves_w[jax.tree_util.keystr(path)], atol=tol, rtol=0,
                err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_sequence_parallel_loss_matches_unsharded_jax(dist_run):
    got, want = dist_run
    g = got["qwen"]
    assert abs(g["loss"] - want["qwen"]) <= TOL * abs(want["qwen"])
    # every layer's flash call took the sequence-parallel layout: q over
    # the model axis along the sequence (dim 1), k whole on "model"
    assert len(g["placements"]) == 2
    for c in g["placements"]:
        assert "Shard(dim=1)" in c.split("), (")[0], c


def test_sequence_parallel_grads_with_remat_on_another_thread(dist_run):
    """The remat recomputation of a sequence-parallel layer, run by a
    backward on another thread than the forward's (the autograd engine's
    own thread for CUDA tensors), takes the forward's layout."""
    got, _ = dist_run
    g = got["qwen_grads"]
    assert g["error"] is None, g["error"]
    # TOL of each entry, or of the largest gradient entry of the model
    scale = max(np.abs(plain).max() for _, plain in g["pairs"])
    for sharded, plain in g["pairs"]:
        np.testing.assert_allclose(sharded, plain, rtol=TOL,
                                   atol=TOL * scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_on_a_mesh_matches_unsharded_jax(dist_run, arch):
    got, want = dist_run
    g, w = got["family"][arch], want["family"][arch]
    assert abs(g - w) <= TOL * abs(w), (g, w)


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_moe_sharded_matches_jax_moe_local(dist_run, mode):
    got, want = dist_run
    g, w = got[f"moe_{mode}"], want[f"moe_{mode}"]
    assert np.abs(w["y"]).max() > 0
    np.testing.assert_allclose(g["y"], w["y"], atol=TOL, rtol=TOL)
    assert abs(g["aux"] - w["aux"]) <= TOL * abs(w["aux"])


def test_podwise_mean_matches_jax(dist_run):
    got, want = dist_run
    g, w = got["podwise"], want["podwise"]
    assert g["same_on_every_rank"]
    np.testing.assert_allclose(g["mean"], w["mean"], atol=1e-6, rtol=0)
    assert np.abs(g["mean"] - w["true"]).max() < 2.1 * w["scale"]


def test_elastic_restore_is_bitwise(dist_run):
    got, _ = dist_run
    e = got["elastic"]
    assert e["mesh"] == (1, 2)
    assert e["bitwise"]
    assert any("Shard" in s for s in e["layouts"])


@pytest.mark.parametrize("run", sorted(LAUNCH_RUNS))
def test_training_launcher_averages_over_ranks(dist_run, run):
    """Every rank logs the loss and gradient norm of the whole batch: the
    first step's to within f32 summation order (the same weights, the
    same batch), the second's within bf16's reach (the parameters are
    bf16 after an AdamW step). The checkpoint rank 0 wrote holds the
    parameters of one process on the whole batch, to within ``3 *
    LAUNCH_LR``: AdamW's first steps move an entry by about ``LAUNCH_LR``
    whatever its gradient, so an entry whose gradient is near 0 may move
    the other way when the ranks sum its parts in another order."""
    got, want = dist_run
    g = got["launcher"][run]
    assert g["rc"] == 0
    w = want["launcher"][run]
    assert len(w) == 2
    for steps in g["steps"]:
        assert [s for s, _, _ in steps] == [1, 2]
        (_, l1, n1), (_, l2, n2) = steps
        assert abs(l1 - w[0][1]) <= 1e-6 * w[0][1], (steps, w)
        assert abs(n1 - w[0][2]) <= 1e-3 * w[0][2], (steps, w)
        assert abs(l2 - w[1][1]) <= 1e-3 * w[1][1], (steps, w)
        assert abs(n2 - w[1][2]) <= 1e-2 * w[1][2], (steps, w)
    single = CheckpointManager(os.path.join(
        g["root"], f"single_ckpt_{run}"), device="cpu").restore(2)
    ranks = CheckpointManager(os.path.join(
        g["root"], f"launch_ckpt_{run}"), device="cpu").restore(2)
    assert sorted(single) == sorted(ranks)
    for k, x in single.items():
        np.testing.assert_allclose(ranks[k].float().numpy(),
                                   x.float().numpy(), atol=3 * LAUNCH_LR,
                                   rtol=0, err_msg=k)
