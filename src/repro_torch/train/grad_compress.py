"""Error-feedback int8 gradient compression.

The JAX package's mechanics for the cross-pod reduction:

    q, scale = quantize(g + e)        # per-tensor symmetric int8
    e'       = (g + e) - dequantize(q, scale)   # residual carried forward
    g_hat    = mean over pods of dequantize(q, scale)

The quantize / dequantize pair runs in the train step and the residual
rides in the state. ``podwise_mean`` is the cross-pod mean: an all-reduce
over the mesh's ``pod`` group of each rank's gradient (the JAX package's
``pmean`` under ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..sharding.rules import current_mesh, is_dtensor
from .tree import stacked_groups, tree_leaves, tree_map, tree_unflatten


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params):
    """Zero residuals in f32, laid out as ``params`` (a DTensor leaf gives
    a DTensor with its placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


@torch.no_grad()
def compress_grads(grads, error_state):
    """Returns (decompressed grads as every receiver sees them, new
    error). The scale is per tensor as the JAX package holds it: one for
    the stack of every layer's leaf (``tree.stacked_groups``)."""
    gs, es = tree_leaves(grads), tree_leaves(error_state)
    deq, err = [None] * len(gs), [None] * len(gs)
    for idx, _ in stacked_groups(grads):
        corrected = torch.stack([gs[i].float() + es[i] for i in idx])
        d = dequantize(*quantize(corrected))
        for j, i in enumerate(idx):
            deq[i], err[i] = d[j], corrected[j] - d[j]
    return tree_unflatten(grads, deq), tree_unflatten(grads, err)


@torch.no_grad()
def podwise_mean(grads, mesh=None, axis_name: str = "pod"):
    """The mean over the ``axis_name`` group of ``mesh`` (default: the
    ambient mesh) of each rank's gradient leaves: an all-reduce sum over
    the group, divided by its size. A plain tensor is the rank's own
    gradient; a DTensor is reduced on its local shard (the peers across
    the group hold the same shard of their own gradients) and keeps its
    layout."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("podwise_mean needs a mesh with a "
                         f"{axis_name!r} axis")
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)

    def one(g):
        local = (g.to_local() if is_dtensor(g) else g).float().clone()
        dist.all_reduce(local, group=group)
        local /= n
        if not is_dtensor(g):
            return local
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride())
    return tree_map(one, grads)
