"""Mesh construction: ``DeviceMesh``es with named dims over the ranks of
the default process group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is
pure data parallelism whose gradient all-reduce is the only cross-pod
collective.

A ``DeviceMesh`` spans the ranks of an initialized process group (NCCL
on cards, gloo on the CPU, or a fake group of any size for the dry run,
``launch/dryrun.py``), one rank per device. Defined as functions, not
module constants: importing this module touches no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels._compat import resolve_device


def _mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over a process group of 256 or 512
    ranks, real or fake."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(_device_type(device), shape, axes)


def make_test_mesh(devices: int | None = None, device=None):
    """A small ("data", "model") mesh over the world's ranks (or the
    first ``devices`` of them): (n/4, 4) from 8 ranks up, (n/2, 2) from 2,
    else (1, 1)."""
    n = devices or dist.get_world_size()
    if n >= 8:
        shape = (n // 4, 4)
    elif n >= 2:
        shape = (n // 2, 2)
    else:
        shape = (1, 1)
    return _mesh(_device_type(device), shape, ("data", "model"))


def make_data_mesh(device=None):
    """A 1-D ("data",) mesh over every rank of the process group: plain
    data parallelism, each rank its share of each batch (the training
    launcher's layout)."""
    return _mesh(_device_type(device), (dist.get_world_size(),), ("data",))


def make_shard_mesh(n_shards: int, devices=None):
    """The first ``n_shards`` cards, as the device list that
    ``core/placement.plan_placement(devices=)`` pins a sharded store's
    shards to, one shard per card (the JAX package's 1-D ("shard",)
    mesh). None when fewer than ``n_shards`` cards exist (the placement
    then runs the shards serially or stacked on one device)."""
    devs = (list(devices) if devices is not None else
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())])
    if n_shards < 1 or len(devs) < n_shards:
        return None
    return tuple(torch.device(d) for d in devs[:n_shards])


def _device_type(device) -> str:
    """The mesh's device type: the CUDA card unless the caller asks for
    the CPU (without a card, asking for none raises)."""
    return resolve_device(device).type
