"""Mixture-of-Experts with static-shape capacity dispatch.

The JAX package's ``apply_moe`` (``src/repro/models/moe.py``) in torch
ops, in four steps that profilers and tests can tell apart:

* :func:`route`: the f32 router, softmax and top-k, the gates
  renormalised, and the Switch load-balancing aux loss;
* :func:`dispatch`: each (token, choice)'s position within its expert's
  capacity buffer by two stable argsorts (rank within expert group);
  choices past the capacity go to the overflow slot ``e * cap`` and are
  dropped (Switch/GLaM semantics);
* :func:`expert_ffn`: the three expert products over the (E, cap, d)
  buffer, as batched matrix products (the JAX package leaves them to
  XLA's einsums, outside any Pallas kernel);
* :func:`combine`: each choice's expert output, times its gate (0 for a
  dropped choice), summed over the token's k choices.

Under a mesh, :func:`apply_moe_sharded` is the JAX package's
expert-parallel ``shard_map`` as a ``local_map``: every ``model`` peer
routes the same tokens of its data shard to the experts it owns (EP) or
to its slice of every expert's FFN (TP), :func:`_moe_local`, and the
peers' outputs are summed over ``model``. Without a mesh it is
``apply_moe``.
"""
from __future__ import annotations

import math

import torch

from ..sharding.rules import current_mesh, is_dtensor, mesh_shape
from .layers import ParamSpec, _act


def moe_spec(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s = {
        # f32, as the JAX package's router product reads its f32 master
        "router": ParamSpec((d, e), "small", matrix=False,
                            axes=("embed", "expert_in")),
        "wi": ParamSpec((e, d, f), axes=("expert", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), axes=("expert", "expert_mlp", "embed")),
    }
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((e, d, f), axes=("expert", "embed", "expert_mlp"))
    return s


def capacity(t: int, cfg, *, no_drop: bool = False) -> int:
    """Slots per expert for ``t`` tokens: ``t * k`` (no token dropped, the
    serving decode's choice), else the JAX package's ``int(max(1,
    round(t * k / e * capacity_factor)))`` with Python's ``round`` (half
    to even)."""
    k, e = cfg.top_k, cfg.n_experts
    if no_drop:
        return t * k
    return int(max(1, round(t * k / e * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them: a stable descending sort and its first ``k`` (``torch.topk``
    does not promise an order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xf: torch.Tensor, cfg):
    """xf: (T, d) -> (gate (T, k) f32, renormalised; idx (T, k) int64;
    aux, the 0-d f32 Switch loss E * sum_e f_e P_e)."""
    e = cfg.n_experts
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate, idx = top_k(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (me * ce).sum()
    return gate, idx, aux


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``ids`` (each in [0, n)) take each value: ``bincount``
    with its length fixed at ``n`` (a shape that does not depend on the
    data, which a fake-tensor trace needs), by an integer scatter-add."""
    return torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(xf: torch.Tensor, idx: torch.Tensor, e: int, cap: int):
    """The capacity buffer of choices ``idx`` (T, k): (hbuf (E, cap, d),
    slot (T k,), keep (T k,) bool). A stable sort by expert id groups the
    choices in arrival order; rank minus the group's start is the choice's
    position in its expert, kept below ``cap``. The buffer has the JAX
    package's padding past the overflow row ``e * cap`` (to a multiple of
    256 rows, its sharding's; unused here)."""
    t, d = xf.shape
    k = idx.shape[1]
    eid = idx.reshape(-1)                                       # (T k,)
    order = torch.argsort(eid, stable=True)
    inv = torch.argsort(order, stable=True)                     # rank of i
    counts = _bincount(eid, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = inv - starts[eid]
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos, e * cap)          # overflow
    pad = (-(e * cap + 1)) % 256 + 1
    buf = xf.new_zeros((e * cap + pad, d))
    # kept slots are distinct; only the overflow row takes several
    # writes, whose order index_put_ on CUDA does not fix, and it is
    # never read back into the buffer the experts see
    buf[slot] = xf.repeat_interleave(k, dim=0)
    return buf[:e * cap].view(e, cap, d), slot, keep


def expert_ffn(p: dict, hbuf: torch.Tensor, cfg) -> torch.Tensor:
    """(E, cap, d) -> (E, cap, d): each expert's (gated) MLP on its
    slots."""
    h = torch.bmm(hbuf, p["wi"])
    if cfg.mlp_gated:
        h = _act(cfg)(torch.bmm(hbuf, p["wg"])) * h
    else:
        h = _act(cfg)(h)
    return torch.bmm(h, p["wo"])


def combine(ybuf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            gate: torch.Tensor, t: int) -> torch.Tensor:
    """(T, d): the outputs at each choice's slot (the overflow slot reads
    a zero row), times its gate where kept, summed over the k choices."""
    e_cap, d = ybuf.shape[0] * ybuf.shape[1], ybuf.shape[2]
    flat = torch.cat([ybuf.reshape(e_cap, d), ybuf.new_zeros((1, d))])
    w = (gate.reshape(-1) * keep).to(ybuf.dtype)[:, None]
    return (flat[slot] * w).reshape(t, -1, d).sum(1)


def apply_moe(p: dict, x: torch.Tensor, cfg, *,
              no_drop: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, 0-d f32).

    ``no_drop=True`` sizes the capacity at the worst case (T k), so no
    token is dropped: the serving decode's setting, where T is tiny."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate, idx, aux = route(p["router"], xf, cfg)
    cap = capacity(t, cfg, no_drop=no_drop)
    hbuf, slot, keep = dispatch(xf, idx, cfg.n_experts, cap)
    ybuf = expert_ffn(p, hbuf, cfg)
    return combine(ybuf, slot, keep, gate, t).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# expert parallelism under a mesh: expert-LOCAL dispatch
# ---------------------------------------------------------------------------
# The tokens stay on their data shard; every model peer routes the SAME
# (replicated) activations to the experts (EP) or the expert-FFN slice
# (TP) it owns, and the only combine collective is one sum over "model"
# of the (T_local, d) outputs.

def _moe_local(xf, router, wi, wg, wo, cfg, *, e_lo: int, e_local: int,
               cap: int):
    """One peer's body. xf: (T_loc, d), the same on every model peer;
    the weights are this peer's expert slice (EP: experts e_lo ..
    e_lo + e_local; TP: a d_ff_expert slice of every expert). Returns
    (this peer's contribution to the output, (T_loc, d); the aux loss of
    its tokens): the caller sums the first over the peers."""
    t, d = xf.shape
    k = cfg.top_k
    gate, idx, aux = route(router, xf, cfg)
    eid = idx.reshape(-1)
    mine = (eid >= e_lo) & (eid < e_lo + e_local)
    eid_m = torch.where(mine, eid - e_lo, e_local)      # sentinel bucket
    order = torch.argsort(eid_m, stable=True)
    inv = torch.argsort(order, stable=True)
    counts = _bincount(eid_m, e_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = inv - starts[eid_m]
    keep = mine & (pos < cap)
    slot = torch.where(keep, eid_m * cap + pos, e_local * cap)
    buf = xf.new_zeros((e_local * cap + 1, d))
    buf[slot] = xf.repeat_interleave(k, dim=0)
    hbuf = buf[:e_local * cap].view(e_local, cap, d)
    p = {"wi": wi, "wo": wo}
    if wg is not None:
        p["wg"] = wg
    ybuf = expert_ffn(p, hbuf, cfg)
    return combine(ybuf, slot, keep, gate, t), aux


def apply_moe_sharded(p: dict, x: torch.Tensor, cfg, *,
                      no_drop: bool = False):
    """EP/TP MoE by ``local_map`` under a mesh whose tensors are
    DTensors; ``apply_moe`` otherwise. EP mode: each ``model`` peer owns
    E/n experts. TP mode (E not divisible, e.g. grok's 8 on a 16-way
    axis): each peer owns a d_ff_expert/n slice of EVERY expert; the same
    sum over ``model`` also completes the partial contraction. The
    capacity comes from the data shard's tokens. Where the JAX package
    falls back to ``apply_moe`` (a batch the data axes do not divide, or
    neither mode), so does the port, on every rank's whole copy."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return apply_moe(p, x, cfg, no_drop=no_drop)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    sizes = mesh_shape(mesh)
    names = list(sizes)
    n_model = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)
    b, s, d = x.shape
    e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
    ep_mode = "model" in sizes and e % n_model == 0 and e >= n_model
    tp_mode = "model" in sizes and not ep_mode and f % n_model == 0
    keys = ["router", "wi"] + (["wg"] if cfg.mlp_gated else []) + ["wo"]
    weights = [p[n] for n in keys]
    if b % dp != 0 or not (ep_mode or tp_mode):
        rep = tuple(Replicate() for _ in names)

        def whole(xl, *ws):
            return apply_moe(dict(zip(keys, ws)), xl, cfg, no_drop=no_drop)
        return local_map(whole, out_placements=(rep, rep),
                         in_placements=(rep,) * (1 + len(keys)),
                         device_mesh=mesh, redistribute_inputs=True)(
                             x, *weights)

    t_loc = (b // dp) * s
    cap = capacity(t_loc, cfg, no_drop=no_drop)
    e_local = e // n_model if ep_mode else e
    e_lo = mesh.get_local_rank("model") * e_local if ep_mode else 0

    def pl(model, data=Replicate()):
        return tuple(Replicate() if sizes[a] == 1 else model if a == "model"
                     else (data if a in dp_axes else Replicate())
                     for a in names)
    x_pl, x_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    w_model = {"router": Replicate(), "wi": Shard(0 if ep_mode else 2),
               "wg": Shard(0 if ep_mode else 2),
               "wo": Shard(0 if ep_mode else 1)}
    w_pl = tuple(pl(w_model[n]) for n in keys)
    # every data shard's tokens reach every weight, and every model peer's
    # output reaches the router: their gradients are partial sums there
    w_grad = tuple(pl(Partial() if n == "router" else w_model[n],
                      Partial()) for n in keys)
    scale = 1.0 / (n_model * dp)

    def body(xl, *ws):
        w = dict(zip(keys, ws))
        y, aux = _moe_local(xl.reshape(-1, d), w["router"], w["wi"],
                            w.get("wg"), w["wo"], cfg, e_lo=e_lo,
                            e_local=e_local, cap=cap)
        # the aux loss, the same on every model peer, is the mean over
        # the data shards: each rank's share, summed
        return y.reshape(xl.shape), aux * scale

    fn = local_map(body, out_placements=(pl(Partial(), Shard(0)),
                                         pl(Partial(), Partial())),
                   in_placements=(x_pl,) + w_pl,
                   in_grad_placements=(x_grad,) + w_grad,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, *weights)
