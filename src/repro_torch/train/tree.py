"""Parameter and state trees: nested dicts, lists and tuples of tensors.

The JAX package's ``jax.tree_util`` calls that the training path makes,
for the port's plain trees: leaves in JAX's order (dict keys sorted), and
each leaf's path in ``jax.tree_util.keystr``'s form (``['layers'][0]
['attn']['wq']``), which names the rows of a checkpoint, so a directory
written by either package opens in the other.

The JAX package stacks its layers: one leaf of shape (L, ...) holds a
parameter of every layer, where the port keeps a list of per-layer
leaves. Whatever it computes per leaf (weight decay where ``ndim >= 2``,
Adafactor's RMS clip, the int8 compression's scale) it computes over the
stack, so the port groups its per-layer leaves the same way
(:func:`stacked_groups`).
"""
from __future__ import annotations

import re
from typing import Any, Callable


def _children(tree):
    """(path piece, child) pairs of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in JAX's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for piece, c in kids for x in leaves_with_path(c, prefix + piece)]


def tree_leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, c, *(r[i] for r in rest))
               for i, c in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken
    in JAX's flatten order (the order of :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(c) for c in t]
            return out if isinstance(t, list) else tuple(out)
        return next(it)

    return build(like)


def stacked_groups(tree) -> list[tuple[list[int], bool]]:
    """The leaves (indices into :func:`tree_leaves`) that the JAX package
    holds as one stacked leaf: leaves whose paths differ only in list
    indices (the port's per-layer list) form one group, in layer order,
    and ``stacked`` is True for them; every other leaf is a group of one.
    """
    groups: dict[str, list[int]] = {}
    stacked: dict[str, bool] = {}
    for i, (path, _) in enumerate(leaves_with_path(tree)):
        key = re.sub(r"\[\d+\]", "[*]", path)
        groups.setdefault(key, []).append(i)
        stacked[key] = key != path
    return [(idx, stacked[k]) for k, idx in groups.items()]
