"""Optimizers: AdamW and Adafactor (factored second moment).

The JAX package's arithmetic on the port's trees of tensors. State is
f32 and ``step`` an int32 0-d tensor, on the parameters' device; every
update is functional (new tensors, the old state untouched), as JAX's
is. The new parameter is ``(p - lr * upd.astype(p.dtype)).astype(
p.dtype)``: the update is cast to the parameter's dtype before it is
scaled, and ``lr`` enters as the parameter's dtype (JAX's weakly typed
Python float), so bf16 parameters round exactly as the JAX package's do.
``state_specs`` gives the state's shapes (the JAX package's also carry
the logical sharding axes, which one card has no use for).

The JAX package's parameters are stacked over layers, and its updates see
the stacked leaf (``tree.stacked_groups``): weight decay applies where the
stacked leaf has ``ndim >= 2`` (so to every per-layer leaf, norm scales
included), and Adafactor's factoring and RMS clip are taken over the
stack. The port's state mirrors its per-layer parameters.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.layers import ParamSpec
from .tree import stacked_groups, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptHyper:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.1
    # adafactor
    decay_rate: float = 0.8
    eps2: float = 1e-30
    clip_threshold: float = 1.0
    factored_min: int = 128       # factor matrices with both dims >= this


def _factorable(shape, hyper: OptHyper) -> bool:
    return len(shape) >= 2 and shape[-1] >= hyper.factored_min and \
        shape[-2] >= hyper.factored_min


def _zeros(shape, axes=()) -> ParamSpec:
    return ParamSpec(tuple(shape), "zeros", matrix=False, axes=tuple(axes))


def state_specs(param_specs, hyper: OptHyper) -> dict:
    """The optimizer state's shapes (``ParamSpec``s of f32 zeros) for a
    tree of parameter ``ParamSpec``s, each with its parameter's logical
    axes (Adafactor's factored moments drop the reduced dim's axis, as
    the JAX package's do)."""
    if hyper.name == "adamw":
        return {"m": tree_map(lambda s: _zeros(s.shape, s.axes),
                              param_specs),
                "v": tree_map(lambda s: _zeros(s.shape, s.axes),
                              param_specs),
                "step": _zeros(())}
    if hyper.name != "adafactor":
        raise ValueError(f"unknown optimizer {hyper.name!r}")

    def vr(s: ParamSpec):
        if _factorable(s.shape, hyper):
            return _zeros(s.shape[:-1], s.axes[:-1])
        return _zeros(s.shape, s.axes)

    def vc(s: ParamSpec):
        if _factorable(s.shape, hyper):
            return _zeros(s.shape[:-2] + s.shape[-1:],
                          s.axes[:-2] + s.axes[-1:])
        return _zeros((1,), (None,) if s.axes else ())  # unused stub

    return {"vr": tree_map(vr, param_specs), "vc": tree_map(vc, param_specs),
            "step": _zeros(())}


def init_state(params, hyper: OptHyper) -> dict:
    """Zeros matching ``state_specs`` on the parameters' device: f32
    moments, an int32 step."""
    dev = tree_leaves(params)[0].device
    specs = state_specs(tree_map(lambda p: ParamSpec(tuple(p.shape)),
                                 params), hyper)
    state = tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32,
                                           device=dev),
                     {k: v for k, v in specs.items() if k != "step"})
    state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
    return state


def _scaled(lr: float, upd: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p - lr * upd.astype(p.dtype)`` in ``p``'s dtype, with ``lr``
    rounded to that dtype first (JAX's weak type)."""
    lr_p = float(torch.tensor(lr, dtype=torch.float32).to(p.dtype))
    return (p - lr_p * upd.to(p.dtype)).to(p.dtype)


def _adamw_update(h: OptHyper, p, g, m, v, step, ndim):
    g = g.float()
    m = h.b1 * m + (1 - h.b1) * g
    v = h.b2 * v + (1 - h.b2) * g * g
    stepf = step.float()
    mh = m / (1 - torch.pow(h.b1, stepf))
    vh = v / (1 - torch.pow(h.b2, stepf))
    upd = mh / (torch.sqrt(vh) + h.eps)
    if ndim >= 2:
        upd = upd + h.weight_decay * p.float()
    return _scaled(h.lr, upd, p), m, v


def _adafactor_update(h: OptHyper, p, g, vr, vc, step, ndim):
    # each f32 temporary of the leaf's size is dropped once it is dead, and
    # the elementwise steps that can run in place do (the same values): at
    # kimi-k2's 163,840 x 7,168 embedding and head one is 4.7 GB, and
    # holding them all to the end of the update did not fit the card
    g = g.float()
    beta2 = 1.0 - step.float() ** (-h.decay_rate)
    g2 = (g * g).add_(h.eps2)
    if _factorable(p.shape, h):
        vr = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
        vc = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
        del g2
        rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=h.eps2)
        pre = torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :]
        upd = g / pre.clamp_(min=1e-30)
        del pre
    else:
        vr = beta2 * vr + (1 - beta2) * g2
        del g2
        upd = g * torch.rsqrt(torch.clamp(vr, min=h.eps2))
    del g
    # RMS clipping
    rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
    upd.div_(torch.clamp(rms / h.clip_threshold, min=1.0))
    if ndim >= 2:
        upd.add_(h.weight_decay * p.float())
    return _scaled(h.lr, upd, p), vr, vc


@torch.no_grad()
def apply_updates(hyper: OptHyper, params, grads, state, lr_scale=1.0):
    """Returns (new_params, new_state)."""
    step = state["step"] + 1
    h = dataclasses.replace(hyper, lr=hyper.lr * lr_scale)
    names = ("m", "v") if hyper.name == "adamw" else ("vr", "vc")
    ins = [tree_leaves(t) for t in (params, grads, state[names[0]],
                                    state[names[1]])]
    outs: list = [None] * len(ins[0])
    for idx, stacked in stacked_groups(params):
        if hyper.name == "adamw" or not stacked:
            # elementwise (AdamW), or a leaf that is its own stack
            fn = _adamw_update if hyper.name == "adamw" else \
                _adafactor_update
            for i in idx:
                outs[i] = fn(h, *(t[i] for t in ins), step,
                             ins[0][i].ndim + stacked)
            continue
        # Adafactor over the JAX package's stacked leaf
        if not _factorable(ins[0][idx[0]].shape, hyper) and _factorable(
                (len(idx),) + tuple(ins[0][idx[0]].shape), hyper):
            raise NotImplementedError(
                "Adafactor factoring a stack of per-layer vectors (as many "
                "layers as factored_min) needs state across layers")
        out = _adafactor_update(h, *(torch.stack([t[i] for i in idx])
                                     for t in ins), step,
                                ins[0][idx[0]].ndim + 1)
        for j, i in enumerate(idx):
            outs[i] = tuple(x[j] for x in out)
    new_p, new_a, new_b = (tree_unflatten(params, [o[i] for o in outs])
                           for i in range(3))
    return new_p, {names[0]: new_a, names[1]: new_b, "step": step}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their
    dtypes; the global norm, a 0-d f32 tensor)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
