"""The port's dry run (``launch/dryrun.py``) on a fake process group of 8
ranks, in a process of its own: one smoke train cell traced on a
(data 2, model 4) mesh under fake tensors. Its per-device parameter
bytes equal the sum of the local shards that the JAX package's
``pspec_for`` gives every parameter (the port's dtypes: matrices in the
config's, the rest f32); its FLOPs are positive and it counts
collectives; its row has the JAX package's roofline keys."""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "llama3.2-1b"
MESH = {"data": 2, "model": 4}

_TRACE = """
import json, sys
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
dryrun.init_fake_group(8)
mesh = make_test_mesh(device="cpu")
row = dryrun.row(get_smoke_config(sys.argv[1]),
                 ShapeConfig("train_s", 64, 8, "train"), mesh, "2x4")
print(json.dumps(row))
"""


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def jax_param_bytes(arch: str) -> int:
    """Per-device bytes of the parameters by the JAX package's rules, in
    the port's dtypes (its f32 masters of the matrices held in the
    config's dtype)."""
    cfg = jax_smoke(arch)
    mat = np.dtype(cfg.dtype).itemsize if cfg.dtype != "bfloat16" else 2
    total = 0
    for path, s in jax.tree_util.tree_flatten_with_path(
            jbuild(cfg).spec,
            is_leaf=lambda x: isinstance(x, jrules.ParamSpec))[0]:
        spec = jrules.pspec_for(s.shape, s.axes, FakeMesh(MESH))
        local = 1
        for n, e in zip(s.shape, tuple(spec) + (None,) * len(s.shape)):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            local *= n // math.prod(MESH[a] for a in axes)
        key = jax.tree_util.keystr(path)
        f32 = (len(s.shape) < 2 or "norm" in key or "router" in key)
        total += local * (4 if f32 else mat)
    return total


def test_smoke_train_cell_on_a_fake_group_of_8():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_TRACE),
                          ARCH], capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["mesh"] == "2x4" and row["mode"] == "train"
    assert row["memory"]["param_bytes"] == jax_param_bytes(ARCH)
    assert row["memory"]["argument_bytes"] > row["memory"]["param_bytes"]
    roof = row["roofline"]
    assert roof["flops_per_device"] > 0
    assert row["hlo_ops"]["n_collectives"] > 0
    assert roof["collective_bytes"] > 0
    assert set(roof) == set(jroof.Roofline(1, 1, {"n_ops": 0}, 1, 1)
                            .as_dict())
    assert roof["n_devices"] == 8


_FLOPS = """
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs.base import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import default_hyper, make_train_step
from repro_torch.models import build
from repro_torch.train.optimizer import init_state
cfg = get_smoke_config(sys.argv[1])
shape = ShapeConfig("train_s", 64, 8, "train")
run = RunConfig()
hyper = default_hyper(cfg, run)
params = build(cfg).init(0, device="cpu")
batch = {k: torch.randint(0, cfg.vocab, (8, 64)) for k in ("tokens", "labels")}
with FlopCounterMode(display=False) as fc:
    make_train_step(cfg, run, hyper)(
        {"params": params, "opt": init_state(params, hyper)}, batch)
dryrun.init_fake_group(8)
row = dryrun.row(cfg, shape, make_test_mesh(device="cpu"), "2x4")
print(json.dumps({"plain": fc.get_total_flops(),
                  "per_device": row["roofline"]["flops_per_device"]}))
"""


def test_dryrun_flops_split_the_step_over_the_ranks():
    """rwkv6-7b-smoke's train step shards every product over the 8 ranks
    of a (data 2, model 4) mesh: the dry run's FLOPs per device are the
    unsharded step's (``FlopCounterMode`` on plain tensors) over 8, each
    product counted once (not again in DTensor's shape propagation)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_FLOPS),
                          "rwkv6-7b"], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["plain"] > 0
    assert got["per_device"] * 8 == got["plain"], got
