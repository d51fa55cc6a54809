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

The JAX package's ``apply_moe_sharded`` runs the expert-parallel
``shard_map`` only under a mesh and otherwise falls back to ``apply_moe``:
one card has no mesh, so the port runs that fallback (the mesh path is
ROADMAP.md Queue 1 item 3).
"""
from __future__ import annotations

import torch

from .layers import ParamSpec, _act


def moe_spec(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s = {
        # f32, as the JAX package's router product reads its f32 master
        "router": ParamSpec((d, e), "small", matrix=False),
        "wi": ParamSpec((e, d, f)),
        "wo": ParamSpec((e, f, d)),
    }
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((e, d, f))
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
    counts = torch.bincount(eid, minlength=e)
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
