"""The new families' mixers and routing against the JAX package's, on the
CPU: MoE dispatch (routed experts, kept slots and dropped choices exactly,
at ``no_drop`` and at a capacity that drops; the top-k tie order), the
Mamba and RWKV chunked scans at ragged lengths and on a stateful
continuation, and M-RoPE. Inputs come from numpy and go to both packages.

Tolerances: MoE outputs within ``F32_TOL`` (1e-5, the same f32 products in
another order) of JAX's; the scans within ``SCAN_TOL`` (1e-5 absolute +
1e-5 relative, elementwise: the port's log-depth composition of the
affine maps against ``jax.lax.associative_scan``'s order); M-RoPE within
1e-6 (the same f32 rotation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32_TOL = 1e-5
SCAN_TOL = (1e-5, 1e-5)


def moe_cfgs(e=4, k=2, cf=8.0):
    args = ("t", "moe", 2, 32, 4, 4, 64, 100)
    kw = dict(n_experts=e, top_k=k, d_ff_expert=64, capacity_factor=cf)
    return JConfig(*args, **kw), ModelConfig(*args, **kw)


def moe_params(cfg, seed, router_std=1.0):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": rng.standard_normal((d, e)) * router_std,
         "wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def jax_routing(p, x, cfg, no_drop):
    """The JAX package's apply_moe routing, step for step
    (src/repro/models/moe.py:52-81): (idx, slot, keep, cap)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    xf = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xf @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = t * k if no_drop else int(max(1, round(t * k / e *
                                                 cfg.capacity_factor)))
    eid = idx.reshape(-1)
    order = jnp.argsort(eid, stable=True)
    inv = jnp.argsort(order, stable=True)
    counts = jnp.bincount(eid, length=e)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = inv - starts[eid]
    keep = pos < cap
    slot = jnp.where(keep, eid * cap + pos, e * cap)
    return (np.asarray(idx), np.asarray(slot), np.asarray(keep), cap)


@pytest.mark.parametrize("cf,no_drop,b,s", [
    (8.0, True, 2, 6), (8.0, False, 2, 6),
    # capacities that drop: round(32 * 2 / 4 * 0.25) = 4 and
    # round(3 * 2 / 4 * 1.0) = 2 (Python's round, half to even: 1.5 -> 2)
    (0.25, False, 2, 16), (1.0, False, 1, 3), (0.5, False, 3, 7)])
def test_moe_routing_and_output_match_jax(cf, no_drop, b, s):
    """Routed experts, kept slots and dropped choices equal the JAX
    package's exactly; the output and the aux loss within F32_TOL."""
    jc, tc = moe_cfgs(cf=cf)
    p = moe_params(tc, 0)
    x = np.random.default_rng(1).standard_normal((b, s, 32)).astype(
        np.float32)
    idx, slot, keep, cap = jax_routing(p, x, jc, no_drop)
    t = b * s
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    xt = torch.as_tensor(x)
    gate, tidx, _ = tmoe.route(tp["router"], xt.reshape(t, -1), tc)
    assert tmoe.capacity(t, tc, no_drop=no_drop) == cap
    _, tslot, tkeep = tmoe.dispatch(xt.reshape(t, -1), tidx, 4, cap)
    assert np.array_equal(tidx.numpy(), idx)
    assert np.array_equal(tslot.numpy(), slot)
    assert np.array_equal(tkeep.numpy(), keep)
    assert keep.all() == (no_drop or cf == 8.0)
    y, aux = tmoe.apply_moe(tp, xt, tc, no_drop=no_drop)
    jy, jaux = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jc, no_drop=no_drop)
    assert np.max(np.abs(y.numpy() - np.asarray(jy))) <= F32_TOL * max(
        1.0, float(np.max(np.abs(jy))))
    assert abs(float(aux) - float(jaux)) <= F32_TOL
    if not keep.all():
        # a token whose choices all dropped gives a zero row
        gone = ~keep.reshape(t, -1).any(1)
        assert np.all(y.numpy().reshape(t, -1)[gone] == 0)


def test_moe_top_k_ties_take_the_lower_index_first():
    """Equal router probabilities (a zero router: every expert 1/E; and
    rows with two equal logits) route as jax.lax.top_k does: the lower
    expert index first."""
    jc, tc = moe_cfgs(e=8, k=4)
    x = np.random.default_rng(2).standard_normal((1, 5, 32)).astype(
        np.float32)
    p = moe_params(tc, 3)
    p["router"][:] = 0
    idx, _, _, _ = jax_routing(p, x, jc, True)
    _, tidx, _ = tmoe.route(torch.as_tensor(p["router"]),
                            torch.as_tensor(x).reshape(5, -1), tc)
    assert np.array_equal(idx, np.tile(np.arange(4), (5, 1)))
    assert np.array_equal(tidx.numpy(), idx)
    # columns 5 and 2 equal, and the largest: 2 before 5
    p = moe_params(tc, 4)
    p["router"][:, 5] = p["router"][:, 2] = 0
    p["router"][:, [0, 1, 3, 4, 6, 7]] = -1.0
    xp = np.abs(x)
    idx, _, _, _ = jax_routing(p, xp, jc, True)
    _, tidx, _ = tmoe.route(torch.as_tensor(p["router"]),
                            torch.as_tensor(xp).reshape(5, -1), tc)
    assert np.array_equal(idx[:, :2], np.tile([2, 5], (5, 1)))
    assert np.array_equal(tidx.numpy(), idx)


def scan_close(got, want) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want)
                       <= SCAN_TOL[0] + SCAN_TOL[1] * np.abs(want)))


def ssm_inputs(rng, b, l, di=24, n=8):
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)) - 1.0))
    return [a.astype(np.float32) for a in (
        dt, rng.standard_normal((b, l, n)), rng.standard_normal((b, l, n)),
        rng.standard_normal((b, l, di)),
        -(np.exp(rng.standard_normal((di, n)) * 0.3) + 1.0),
        rng.standard_normal((b, di, n)) * 0.5)]


@pytest.mark.parametrize("l", [1, 37, 128, 129, 300])
def test_ssm_scan_chunked_matches_jax_at_ragged_lengths(l):
    """ssm_scan_chunked (chunk 128) against the JAX package's at lengths
    on and off the chunk, from a nonzero state, and against the port's
    own sequential recurrence."""
    args = ssm_inputs(np.random.default_rng(l), 2, l)
    jy, jh = jssm.ssm_scan_chunked(*map(jnp.asarray, args))
    ty, th = tssm.ssm_scan_chunked(*map(torch.as_tensor, args))
    assert scan_close(ty.numpy(), jy) and scan_close(th.numpy(), jh)
    sy, sh = tssm.ssm_scan_sequential(*map(torch.as_tensor, args))
    assert scan_close(ty.numpy(), sy.numpy()) and scan_close(th.numpy(),
                                                             sh.numpy())


@pytest.mark.parametrize("l", [1, 33, 70])
def test_wkv_chunked_matches_jax_at_ragged_lengths(l):
    """wkv_chunked (chunk 32) against the JAX package's at lengths on and
    off the chunk, from a nonzero state, and the port's sequential
    recurrence."""
    rng = np.random.default_rng(100 + l)
    b, h, dk = 2, 3, 8
    r, k, v = (rng.standard_normal((b, l, h, dk)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((b, l, h, dk)), -8, 4))
    u = rng.standard_normal((h, dk))
    s0 = rng.standard_normal((b, h, dk, dk)) * 0.5
    args = [r, k, v, logw.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32)]
    jo, js = jrwkv.wkv_chunked(*map(jnp.asarray, args))
    to, ts = trwkv.wkv_chunked(*map(torch.as_tensor, args))
    assert scan_close(to.numpy(), jo) and scan_close(ts.numpy(), js)
    so, ss = trwkv.wkv_sequential(*map(torch.as_tensor, args))
    assert scan_close(to.numpy(), so.numpy()) and scan_close(ts.numpy(),
                                                             ss.numpy())


def mixer_cfgs(kind):
    args = ("t", "hybrid" if kind == "mamba" else "ssm", 2, 32, 4, 4, 64,
            100)
    kw = dict(ssm_state=8, ssm_conv=4, ssm_expand=2, rwkv=kind == "rwkv")
    return JConfig(*args, **kw), ModelConfig(*args, **kw)


def mixer_params(spec, rng):
    def draw(s):
        if s.init in ("zeros", "ones"):
            # nonzero, so the mixes, decay and bonus take part
            return (rng.standard_normal(s.shape) * 0.3
                    + (s.init == "ones")).astype(np.float32)
        return (rng.standard_normal(s.shape) * s.std).astype(np.float32)
    return {k: draw(s) for k, s in spec.items()}


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_mixer_forward_and_stateful_continuation_match_jax(kind):
    """mamba_forward / rwkv_time_mix over 45 tokens, and over 20 then 25
    from the carried state (conv tail and h; wkv state and shift), equal
    the JAX package's, and the split run equals the whole one."""
    jc, tc = mixer_cfgs(kind)
    rng = np.random.default_rng(5)
    if kind == "mamba":
        p = mixer_params(tssm.ssm_spec(tc), rng)
        fwd_t = lambda x, st=None: tssm.mamba_forward(  # noqa: E731
            p_t, x, tc, state=st)
        fwd_j = jax.jit(lambda x, st=None: jssm.mamba_forward(
            p_j, x, jc, state=st))
    else:
        p = mixer_params(trwkv.rwkv_time_spec(tc), rng)

        def fwd_t(x, st=None):
            y, (s, shift) = trwkv.rwkv_time_mix(p_t, x, tc, state=st)
            return y, trwkv.RWKVState(s, shift, shift)

        @jax.jit
        def fwd_j(x, st=None):
            y, (s, shift) = jrwkv.rwkv_time_mix(p_j, x, jc, state=st)
            return y, jrwkv.RWKVState(s, shift, shift)
    p_t = {k: torch.as_tensor(v) for k, v in p.items()}
    p_j = {k: jnp.asarray(v) for k, v in p.items()}
    x = rng.standard_normal((2, 45, 32)).astype(np.float32)
    yt, st = fwd_t(torch.as_tensor(x))
    yj, sj = fwd_j(jnp.asarray(x))
    assert scan_close(yt.numpy(), yj)
    for a, b in zip(st, sj):
        assert scan_close(a.numpy(), b)
    y1, s1 = fwd_t(torch.as_tensor(x[:, :20]))
    y2, s2 = fwd_t(torch.as_tensor(x[:, 20:]), s1)
    j1, js1 = fwd_j(jnp.asarray(x[:, :20]))
    j2, js2 = fwd_j(jnp.asarray(x[:, 20:]), js1)
    assert scan_close(y2.numpy(), j2)
    assert scan_close(torch.cat([y1, y2], 1).numpy(), yt.numpy())
    for a, b in zip(s2, st):
        assert scan_close(a.numpy(), b.numpy())


def test_mrope_matches_jax():
    """M-RoPE: the D/2 frequency slots split into (t, h, w) sections, each
    rotated by its own position row, against the JAX package's, and
    equal to plain RoPE when the three rows agree; a 2-D position array
    or sections that do not cover D/2 raise."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    for sections in ((2, 3, 3), (4, 2, 2)):
        got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                                 1e6, sections)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  sections)
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-6
    same = np.broadcast_to(pos[0], (3, 2, 7)).copy()
    got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(same), 1e6,
                             (2, 3, 3))
    plain = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]),
                               1e6)
    assert torch.equal(got, plain)
    with pytest.raises(ValueError, match="M-RoPE"):
        tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]), 1e6,
                           (2, 3, 3))
    with pytest.raises(ValueError, match="cover"):
        tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                           (2, 3, 2))
