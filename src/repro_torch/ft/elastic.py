"""Elastic scaling: restore a checkpoint onto a different mesh.

Checkpoints are mesh-agnostic (host-row chunks in the versioned store,
``ft/checkpoint.py``), so elasticity reduces to (1) choosing a new mesh
from the surviving ranks, (2) recomputing the layouts from the same
logical-axis rules on that mesh, (3) distributing each leaf at restore.
Data order is preserved by carrying (step, dataset version ts) in the
train metadata, so a shrink replays no data and loses at most the steps
since the last checkpoint.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels._compat import resolve_device
from ..sharding.rules import tree_shardings


def choose_mesh_shape(n_devices: int, prefer_model: int = 16) -> tuple:
    """Largest (data, model) grid for the surviving devices: keep TP width
    if possible (weights layouts unchanged), shrink DP."""
    model = prefer_model
    while model > 1 and (n_devices % model or n_devices // model < 1):
        model //= 2
    return (max(n_devices // model, 1), model)


def remesh(devices=None, prefer_model: int = 16, device=None):
    """A ("data", "model") ``DeviceMesh`` of :func:`choose_mesh_shape`
    over the ranks ``devices`` (default: every rank of the process
    group). Every rank of the group calls it; a rank outside the new
    mesh gets the mesh with no coordinate on it. ``device``: the mesh's
    device type (None: the CUDA card)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = (list(devices) if devices is not None
             else list(range(dist.get_world_size())))
    data, model = choose_mesh_shape(len(ranks), prefer_model)
    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=("data", "model"))


def restore_elastic(ckpt_manager, step: int, like, spec_tree, mesh):
    """``CheckpointManager.restore`` with the layouts recomputed for
    ``mesh``."""
    shardings = tree_shardings(spec_tree, mesh)
    return ckpt_manager.restore(step, like=like, mesh=mesh,
                                shardings=shardings)
