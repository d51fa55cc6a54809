"""The port's sharding rules against the JAX package's, on stand-in meshes
(no devices, no process group).

The 11 cases of ``tests/test_sharding_rules.py`` through the port; then
``pspec_for`` over every parameter and optimizer-state leaf of every
arch's ``CONFIG`` and ``SMOKE`` on (16, 16), (2, 16, 16), (2, 4) and
(1, 4) meshes, equal entry for entry to the JAX package's with its
leading ``"layers"`` entry dropped; ``shard_batch_specs`` and the decode
state's layouts (``cache_axes``, ``decode_state_specs``) likewise;
``placements_for``; the roofline's ``model_flops`` for every cell and
``collective_bytes`` against the JAX function on a hand-written HLO
snippet; and ``choose_mesh_shape`` for every device count up to 600.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import shapes_for as jax_shapes_for  # noqa: E402
from repro.ft import elastic as jelastic  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import abstract_decode_state as jax_decode_state  # noqa: E402
from repro.models import batch_specs as jax_batch_specs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.transformer import pattern as jax_pattern  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import shapes_for  # noqa: E402
from repro_torch.ft.elastic import choose_mesh_shape  # noqa: E402
from repro_torch.core.placement import plan_placement  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.models import abstract_decode_state, batch_specs  # noqa: E402
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.tree import leaves_with_path  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: pspec_for only reads axis_names and shape."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})

#: the JAX package's cases, each (shape, axes, mesh, want)
CASES = {
    "basic_tp_fsdp": ((2048, 32, 64), ("embed", "heads", "head_dim"),
                      SINGLE, P("data", "model", None)),
    "kv_heads_fallback_replicates": (
        (6144, 8, 128), ("embed", "kv_heads", "head_dim"), SINGLE,
        P("data", None, None)),
    "qwen_odd_heads_fallback": ((896, 14, 64), ("embed", "heads", "head_dim"),
                                SINGLE, P("data", None, None)),
    "whisper_vocab_fallback": ((51865, 1024), ("vocab", "embed_tbl"), SINGLE,
                               P(None, None)),
    "kimi_expert_parallelism": (
        (384, 7168, 2048), ("expert", "embed", "expert_mlp"), SINGLE,
        P("model", "data", None)),
    "grok_expert_fallback_to_tp": (
        (8, 6144, 32768), ("expert", "embed", "expert_mlp"), SINGLE,
        P(None, "data", "model")),
    "axis_used_once_per_tensor": ((64, 64), ("heads", "mlp"),
                                  FakeMesh({"model": 16}), P("model", None)),
    "batch_multi_pod": ((256, 4096), ("batch", "seq"), POD,
                        P(("pod", "data"), None)),
    "batch_fallback_single_axis": ((8, 128), ("batch", "seq"), POD,
                                   P(None, None)),
    "decode_cache_sequence_sharding": (
        (64, 128, 32768, 8, 128),
        ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), POD,
        P(None, ("pod", "data"), "model", None, None)),
    "rwkv_projection_sharding": ((4096, 4096), ("embed", "heads_flat"),
                                 SINGLE, P("data", "model")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_cases_through_the_port(case):
    shape, axes, mesh, want = CASES[case]
    got = rules.pspec_for(shape, axes, mesh)
    assert got == tuple(want)
    assert got == tuple(jrules.pspec_for(shape, axes, mesh))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "1x4": {"data": 1, "model": 4}}


def abstract_mesh(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def jax_leaf_of(cfg, path: str) -> str:
    """The JAX package's stacked leaf of a port parameter leaf path: the
    port's per-layer lists are the JAX package's stacked blocks (whisper:
    one stacked dict per stack; the decoder-only families: one per
    position of the layer pattern)."""
    if cfg.family == "encdec":
        path = re.sub(r"\['enc_layers'\]\[\d+\]", "['enc_blocks']", path)
        return re.sub(r"\['dec_layers'\]\[\d+\]", "['dec_blocks']", path)
    period = jax_pattern(cfg)[0]
    return re.sub(r"\['layers'\]\[(\d+)\]",
                  lambda m: f"['blocks'][{int(m.group(1)) % period}]", path)


def port_and_jax_specs(cfg, tree_port, tree_jax):
    """(path, port ParamSpec, JAX ParamSpec) for every port leaf."""
    jl = {jax.tree_util.keystr(p): x for p, x in
          jax.tree_util.tree_flatten_with_path(
              tree_jax, is_leaf=lambda x: isinstance(x, jrules.ParamSpec))[0]}
    for path, spec in leaves_with_path(tree_port):
        yield path, spec, jl[jax_leaf_of(cfg, path)]


ARCH_CONFIGS = [(a, kind) for a in ARCH_IDS for kind in ("config", "smoke")]


def the_configs(arch, kind):
    if kind == "config":
        return get_config(arch), jax_config(arch)
    return get_smoke_config(arch), jax_smoke(arch)


@pytest.mark.parametrize("arch,kind", ARCH_CONFIGS)
def test_pspec_for_every_leaf_matches_jax(arch, kind):
    cfg, jcfg = the_configs(arch, kind)
    jspec = jbuild(jcfg).spec
    pspec_tree = model_spec(cfg)
    trees = [(pspec_tree, jspec)]
    for name in ("adamw", "adafactor"):
        trees.append((topt.state_specs(pspec_tree, topt.OptHyper(name=name)),
                      jopt.state_specs(jspec, jopt.OptHyper(name=name))))
    n = 0
    for tp, tj in trees:
        for path, ps, js in port_and_jax_specs(cfg, tp, tj):
            stacked = len(js.shape) == len(ps.shape) + 1
            jshape = js.shape[1:] if stacked else js.shape
            jaxes = js.axes[1:] if stacked else js.axes
            if stacked:
                assert js.axes[0] == "layers", path
            assert ps.shape == jshape and tuple(ps.axes) == tuple(jaxes), \
                (path, ps, js)
            for mshape in MESHES.values():
                mesh = FakeMesh(mshape)
                want = tuple(jrules.pspec_for(js.shape, js.axes, mesh))
                want = want[1:] if stacked else want
                assert rules.pspec_for(ps.shape, ps.axes, mesh) == want, \
                    (path, mshape)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_state_layouts_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert [s.name for s in shapes_for(cfg)] == \
        [s.name for s in jax_shapes_for(jcfg)]
    for mshape in MESHES.values():
        mesh = abstract_mesh(mshape)
        for shape in shapes_for(cfg):
            jshape = SHAPES[shape.name]
            got = rules.shard_batch_specs(batch_specs(cfg, shape), mesh)
            want = jrules.shard_batch_specs(jax_batch_specs(jcfg, jshape),
                                            mesh)
            assert set(got) == set(want)
            for k in got:
                assert got[k].spec == tuple(want[k].sharding.spec), (k, shape)
            if shape.mode != "decode":
                continue
            state = abstract_decode_state(cfg, shape)
            specs = rules.decode_state_specs(cfg, state, mesh)
            jstate = jrules.shard_decode_state(
                jcfg, jax_decode_state(jcfg, jshape), mesh)
            jl = {jax.tree_util.keystr(p): x for p, x in
                  jax.tree_util.tree_flatten_with_path(jstate)[0]}
            assert specs and all(v == () or len(v) >= 2
                                 for v in specs.values())
            for path, spec in specs.items():
                jspec = jl[jax_state_path(cfg, path)].sharding.spec
                assert spec == tuple(jspec)[1:], (path, spec, jspec)


def jax_state_path(cfg, path: str) -> str:
    """The JAX package's stacked decode-state leaf of a port leaf path
    (``.caches[l].k`` -> ``.caches[l % period].k``; whisper's per-layer
    lists -> one stacked leaf)."""
    if cfg.family == "encdec":
        return re.sub(r"\[\d+\]", "", path)
    period = jax_pattern(cfg)[0]
    return re.sub(r"\.caches\[(\d+)\]",
                  lambda m: f".caches[{int(m.group(1)) % period}]", path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in shapes_for(cfg):
        assert roofline.model_flops(cfg, shape) == \
            jroof.model_flops(jcfg, SHAPES[shape.name])


HLO = """
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,2048]{1,0} all-gather(bf16[16,2048]{1,0} %y), replica_groups=[4,4]<=[16], dimensions={0}
  %rs = f32[128]{0} reduce-scatter(f32[2048]{0} %z), replica_groups=[2,16]<=[32], dimensions={0}, to_apply=%add
  %a2a = bf16[32,1024]{1,0} all-to-all(bf16[32,1024]{1,0} %w), replica_groups={{0,1}}, dimensions={0}
  %cp = s32[7]{0} collective-permute(s32[7]{0} %v), source_target_pairs={{0,1}}
"""

RECORDS = [{"op": "all-reduce", "bytes": 1024 * 512 * 4, "group": 4},
           {"op": "all-gather", "bytes": 64 * 2048 * 2, "group": 4},
           {"op": "reduce-scatter", "bytes": 128 * 4, "group": 16},
           {"op": "all-to-all", "bytes": 32 * 1024 * 2, "group": 2},
           {"op": "collective-permute", "bytes": 7 * 4, "group": 2}]


def test_collective_bytes_match_jax_on_hlo():
    want = jroof.collective_bytes(HLO)
    assert want["n_ops"] == 5
    assert roofline.collective_bytes(RECORDS) == want
    r = roofline.Roofline(1e12, 1e9, want, 5e14, 8).as_dict()
    assert set(r) == set(jroof.Roofline(1e12, 1e9, want, 5e14, 8).as_dict())
    total = sum(v for k, v in want.items() if k != "n_ops")
    assert r["collective_bytes"] == total
    assert r["t_collective_s"] == total / roofline.LINK_BW
    assert r["t_compute_s"] == 1e12 / roofline.PEAK_TENSOR_BF16


def test_placements_for():
    from torch.distributed.tensor import Replicate, Shard
    pod = FakeMesh(MESHES["2x16x16"])
    assert rules.placements_for(("data", "model", None), SINGLE) == \
        (Shard(0), Shard(1))
    assert rules.placements_for((None, None), SINGLE) == \
        (Replicate(), Replicate())
    assert rules.placements_for((("pod", "data"), None), pod) == \
        (Shard(0), Shard(0), Replicate())
    assert rules.placements_for((None, "data", "model"), pod) == \
        (Replicate(), Shard(1), Shard(2))
    assert rules.local_shape((256, 4096), (("pod", "data"), "model"), pod) \
        == (8, 256)


def test_scan_placements():
    """The per-rank layout of the Mamba scan and the WKV recurrence: batch
    rows on the axes the ``batch`` rule gives them, the channel or head
    dim on ``model`` where it divides, replicated otherwise and on any
    mesh dim of size 1."""
    from torch.distributed.tensor import Replicate, Shard
    rep = Replicate()
    pl = rules.scan_placements(SINGLE, 32, 64)
    assert pl(2) == [Shard(0), Shard(2)]
    assert pl(None) == [Shard(0), rep]
    assert pl(0, rep) == [rep, Shard(0)]
    assert rules.scan_placements(SINGLE, 32, 24)(2) == [Shard(0), rep]
    assert rules.scan_placements(SINGLE, 8, 64)(1) == [rep, Shard(1)]
    pod = FakeMesh(MESHES["2x16x16"])
    assert rules.scan_placements(pod, 64, 64)(2) == [Shard(0), Shard(0),
                                                     Shard(2)]
    one = FakeMesh({"data": 1, "model": 4})
    assert rules.scan_placements(one, 4, 8)(1) == [rep, Shard(1)]


def test_constrain_is_a_no_op_without_a_mesh_or_on_plain_tensors():
    x = torch.ones(4, 4)
    assert rules.constrain(x, ("batch", None)) is x
    with rules.use_mesh(SINGLE):
        assert rules.current_mesh() is SINGLE
        assert rules.constrain(x, ("batch", None)) is x
    assert rules.current_mesh() is None


def test_choose_mesh_shape_every_n():
    for n in range(1, 601):
        for prefer in (16, 8, 4):
            assert choose_mesh_shape(n, prefer) == \
                jelastic.choose_mesh_shape(n, prefer), (n, prefer)


@pytest.mark.parametrize("n_shards,n_devices", [(1, 0), (2, 1), (2, 2),
                                                (3, 4), (4, 4), (5, 4)])
def test_make_shard_mesh_and_the_placement_it_plans(n_shards, n_devices):
    """The first ``n_shards`` devices, or None with fewer (the JAX
    package's ``make_shard_mesh``); ``plan_placement`` pins a sharded
    store's shards to that list."""
    import torch
    devs = [torch.device("cpu", i) for i in range(n_devices)]
    mesh = make_shard_mesh(n_shards, devs)
    if n_devices < n_shards:
        assert mesh is None
    else:
        assert mesh == tuple(devs[:n_shards])
    plan = plan_placement(n_shards, devices=devs, force="auto")
    if n_shards >= 2 and mesh is not None:
        assert plan.mode == "mesh" and plan.devices == mesh
    else:
        assert plan.mode != "mesh"
