"""Carry parameters across from the JAX package's parameter tree.

The JAX package's tree, as numpy arrays, is ``{"embed": {"tok"[, "head"]},
"blocks": [one dict per position of the layer pattern
(``transformer.pattern``), each leaf stacked over the pattern's groups],
"final_norm"}``: layer ``l`` is position ``l % period`` of group ``l //
period`` (dense and rwkv6: a period of one layer, so one dict whose leaves
carry a leading layer axis; jamba: a period of 8 sublayer trees, with
attention, Mamba, MLP and MoE leaves). ``from_jax_tree`` unstacks it into
the port's per-layer tree on a device, casting the matrices to the
config's dtype (the JAX package keeps f32 masters and casts them at each
use, with the same rounding) and keeping the f32 parameters (norms, the
MoE router, the SSM's dt, A and skip, RWKV's decay and bonus) in f32.
``to_jax_tree`` is the inverse, in f32.

Whisper's tree (family ``encdec``) is ``{"embed": {"tok", "head"},
"enc_blocks", "enc_final", "dec_blocks", "final_norm"}``, each of
``enc_blocks`` / ``dec_blocks`` one dict whose leaves carry a leading
layer axis; the port's lists are ``enc_layers`` / ``dec_layers``
(``models/whisper.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels._compat import resolve_device
from . import transformer as tf
from .layers import ParamSpec
from .model import model_spec

#: whisper's stacked JAX blocks -> the port's per-layer lists
_ENCDEC_STACKS = (("enc_blocks", "enc_layers"), ("dec_blocks", "dec_layers"))


def _leaves(spec, tree, path=()):
    """(path, ParamSpec, array) for every leaf of ``spec`` in ``tree``."""
    if isinstance(spec, ParamSpec):
        yield path, spec, tree
        return
    keys = spec.keys() if isinstance(spec, dict) else range(len(spec))
    for k in keys:
        yield from _leaves(spec[k], tree[k], path + (k,))


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _map(fn, tree):
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: list):
    """One tree whose leaves stack the leaves of ``trees`` (same keys)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stacked(cfg, layers: list) -> list:
    """The per-layer trees ``layers`` as the JAX package's ``blocks``."""
    period, groups = tf.pattern(cfg)
    return [_stack([layers[g * period + i] for g in range(groups)])
            for i in range(period)]


def _unstacked(cfg, tree: dict) -> dict:
    """The JAX package's tree in the port's layout (leaves still host
    arrays): each stack cut into per-layer trees."""
    if cfg.family == "encdec":
        out = {k: tree[k] for k in ("embed", "enc_final", "final_norm")}
        for jk, pk in _ENCDEC_STACKS:
            n = cfg.encoder_layers if jk == "enc_blocks" else cfg.n_layers
            out[pk] = [_map(lambda a, l=l: a[l], tree[jk]) for l in range(n)]
        return out
    blocks = tree["blocks"]
    period, _ = tf.pattern(cfg)
    if len(blocks) != period:
        raise ValueError(f"{cfg.name}: a layer pattern of {period}, got "
                         f"{len(blocks)} blocks")
    return {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "layers": [_map(lambda a, g=l // period: a[g],
                            blocks[l % period])
                       for l in range(cfg.n_layers)]}


def _restacked(cfg, port_like: dict) -> dict:
    """The inverse of :func:`_unstacked` on host arrays."""
    if cfg.family == "encdec":
        out = {k: port_like[k] for k in ("embed", "enc_final", "final_norm")}
        for jk, pk in _ENCDEC_STACKS:
            out[jk] = _stack(port_like[pk])
        return out
    return {"embed": port_like["embed"],
            "final_norm": port_like["final_norm"],
            "blocks": _stacked(cfg, port_like["layers"])}


def from_jax_tree(cfg, tree: dict, device=None) -> dict:
    """The JAX package's parameter tree (numpy or array-likes) -> the
    port's parameter tree on ``device`` (None: the CUDA card). Raises on a
    missing leaf, a block count that is not the pattern's period, or a
    shape that does not fit ``cfg``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    spec = model_spec(cfg)
    jax_like = _unstacked(cfg, tree)
    out = _empty_like(spec)
    for path, s, arr in _leaves(spec, jax_like):
        arr = np.array(arr, np.float32)  # a writable host copy
        if arr.shape != s.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{arr.shape} != {s.shape}")
        t = torch.from_numpy(arr).to(dev)
        _set(out, path, t.to(dtype) if s.matrix else t)
    return out


def to_jax_tree(cfg, params: dict) -> dict:
    """The port's parameter tree -> the JAX package's layout, as f32 numpy
    arrays stacked over the pattern's groups."""
    def host(t):
        return t.detach().float().cpu().numpy()

    return _restacked(cfg, {k: ([_map(host, lay) for lay in v]
                                if isinstance(v, list) else _map(host, v))
                            for k, v in params.items()})


def random_tree(cfg, rng: np.random.Generator) -> dict:
    """A JAX-layout f32 parameter tree drawn from a numpy generator with
    the port's init rules (``layers.ParamSpec``): the host-side source of
    seeded weights that both packages can load. These follow the JAX
    package's rules except for the attention weights, whose fan-in is
    their contracted dims (see ``layers.py`` and ROADMAP.md Queue 3)."""
    spec = model_spec(cfg)

    def draw(s: ParamSpec):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        x = rng.standard_normal(s.shape, dtype=np.float32)
        x *= np.float32(s.std)
        return x

    port_like = _empty_like(spec)
    for path, s, _ in _leaves(spec, spec):
        _set(port_like, path, draw(s))
    return _restacked(cfg, port_like)


def _empty_like(spec):
    if isinstance(spec, ParamSpec):
        return None
    if isinstance(spec, dict):
        return {k: _empty_like(v) for k, v in spec.items()}
    return [_empty_like(v) for v in spec]
