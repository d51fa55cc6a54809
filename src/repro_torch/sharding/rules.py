"""Logical-axis -> mesh-axis rules with divisibility fallback chains, on
PyTorch's ``DeviceMesh`` and DTensor.

Every parameter and cache dim carries a logical name (the ``axes`` of the
``ParamSpec``s in ``models/*.py``). A rule is a priority list of mesh-axis
tuples; for each tensor the dims are walked in order, and each takes the
first candidate that (a) exists on the mesh, (b) is not used by another
dim of the same tensor and (c) divides the dim. Odd published dims
degrade instead of failing: whisper's vocab 51865 falls back to
replicated, qwen2-0.5b's 14 heads replicate (and its attention takes the
sequence-parallel branch, ``models/attention.py``), grok's 8 experts fall
through to expert-FFN tensor parallelism.

Parallelism mapping (DP/FSDP/TP/EP/SP), the JAX package's:
  batch        -> (pod, data)      pure DP (gradient all-reduce)
  embed        -> data             FSDP / ZeRO-3 parameter+optimizer sharding
  heads/mlp/.. -> model            TP (Megatron-style)
  expert       -> model            EP (falls back to expert_mlp TP)
  kv_seq       -> model            SP for decode caches

The JAX package hands the resulting ``PartitionSpec`` to GSPMD. Here a
spec is a plain tuple with the same entries (None, an axis name, or a
tuple of names), and :func:`placements_for` turns it into DTensor
placements: ``Shard(dim)`` on each mesh dim that shards a tensor dim,
``Replicate()`` on the rest. DTensor then propagates shardings through
the model's torch ops, as GSPMD does through the XLA program.

The ambient mesh (:func:`use_mesh`, :func:`current_mesh`) is the
counterpart of JAX's ``with mesh:``. One difference by design: the JAX
``constrain`` swallows every exception and returns its input; inside a
mesh the port's :func:`constrain` raises (a constraint that cannot be
met is a fault to see, not a layout to drop quietly).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import TYPE_CHECKING, Any, Mapping, NamedTuple, Sequence

import torch

if TYPE_CHECKING:      # the models import this module
    from ..models.layers import ParamSpec

Rules = dict[str | None, list[tuple[str, ...]]]

DEFAULT_RULES: Rules = {
    # parameters
    "vocab": [("model",), ()],
    "embed": [("data",), ()],
    "embed_tbl": [()],        # see models/layers.embed_spec
    "embed_out": [()],
    "heads": [("model",), ()],
    "kv_heads": [("model",), ()],
    # head_dim deliberately unsharded by default: sharding it splits RoPE's
    # rotate-half halves across devices. kv_heads' fallback is replication
    # (standard when kv < TP).
    "head_dim": [()],
    "mlp": [("model",), ()],
    "expert": [("model",), ()],
    "expert_in": [()],
    "expert_mlp": [("model",), ()],
    "ssm_inner": [("model",), ()],
    "heads_flat": [("model",), ()],
    "layers": [()],
    None: [()],
    # activations / caches
    "batch": [("pod", "data"), ("data",), ()],
    "seq_sp": [("model",), ()],   # sequence-parallel attention (odd head counts)
    "exp_cap": [("data",), ()],   # MoE capacity dim when expert dim fell back
    "seq": [()],
    "kv_seq": [("model",), ()],
    "act_embed": [()],
}

#: a spec entry per tensor dim: None, a mesh axis name, or several
Spec = tuple


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` and its
    shape tuple) or of any object with ``axis_names`` and a ``shape``
    mapping (the tests' stand-in meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in shape)))


def _axis_size(sizes: Mapping[str, int], axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes)


def pspec_for(shape: Sequence[int], axes: Sequence[str | None], mesh,
              rules: Rules | None = None) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the logical
    ``axes``, by ``rules`` (default :data:`DEFAULT_RULES`) on ``mesh``:
    the JAX package's ``PartitionSpec`` entries, as a tuple."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, name in zip(shape, axes):
        assigned: Any = None
        for cand in rules.get(name, [()]):
            if not cand:
                break
            if not all(a in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            size = _axis_size(sizes, cand)
            if dim % size == 0 and dim >= size:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        entries.append(assigned)
    return tuple(entries)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d``'s entry names the mesh dim (an
    entry of several names, ``("pod", "data")``, shards its dim over each
    of them, major first as the mesh orders them), else ``Replicate()``;
    ``Replicate()`` on a mesh dim of size 1 too, where the two are the
    same layout (DTensor refuses to reshape a dim it holds as sharded,
    even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
    dim_of = {a: d for d, e in enumerate(spec) for a in _entry_axes(e)}
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in sizes)


def scan_placements(mesh, rows: int, inner: int):
    """The placements of a recurrence run per rank by ``local_map``
    (the Mamba scan, the WKV recurrence), as a function: ``pl(dim,
    batch=Shard(0))`` gives one placement a mesh dim, ``batch`` on the
    axes that the ``batch`` rule gives ``rows`` batch rows, ``Shard(dim)`` on
    ``model`` where it divides ``inner`` (the channels or heads, which the
    recurrence runs apart) and ``dim`` is not None, else (and on any mesh
    dim of size 1) ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
    baxes = _entry_axes(pspec_for((rows,), ("batch",), mesh)[0])
    split = "model" in sizes and inner % sizes["model"] == 0

    def pl(dim, batch=Shard(0)):
        return [Replicate() if sizes[ax] == 1 else batch if ax in baxes
                else Shard(dim) if ax == "model" and split
                and dim is not None else Replicate() for ax in sizes]
    return pl


def replicated(t, mesh):
    """``t`` as a DTensor replicated over ``mesh`` (a decode state made
    outside the mesh), or as it is where it is a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * len(mesh_shape(mesh)),
                              run_check=False)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """Each rank's shard of a tensor of ``shape`` laid out by ``spec``
    (which ``pspec_for`` makes divide evenly)."""
    sizes = mesh_shape(mesh)
    return tuple(n // _axis_size(sizes, _entry_axes(e))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                      default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (JAX's ``with
    mesh:``): :func:`constrain`, the sequence-parallel attention and the
    sharded MoE read it. Inside it a plain tensor that meets a DTensor
    in an op counts as replicated (DTensor's ``implicit_replication``),
    as an unannotated array does under JAX's mesh: positions, masks and
    constants made inside the model. Blocks nest: leaving an inner one
    restores the setting the outer one made."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    token = _MESH.set(mesh)
    # DTensor's own implicit_replication() turns the setting off on exit,
    # which would end an enclosing block's early
    was = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        dispatcher._allow_implicit_replication = was
        _MESH.reset(token)


def current_mesh():
    """The ambient ``DeviceMesh``, or None outside :func:`use_mesh`."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full_tensor(x):
    """A DTensor gathered whole (a collective over its mesh); any other
    value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x, axes: Sequence[str | None], rules: Rules | None = None):
    """Redistribute the DTensor ``x`` to the layout its logical ``axes``
    get on the ambient mesh (``with_sharding_constraint`` by logical
    axes). A no-op on a plain tensor or outside a mesh. Raises where the
    JAX package's swallows: a DTensor on another mesh, axes that do not
    fit its dims."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    if x.device_mesh != mesh:
        raise ValueError("constrain: the tensor lies on another mesh than "
                         "the ambient one")
    if len(axes) != x.ndim:
        raise ValueError(f"constrain: {len(axes)} axes for a {x.ndim}-D "
                         f"tensor")
    want = placements_for(pspec_for(x.shape, axes, mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def layout_like(new, old):
    """``new`` laid out as ``old`` is where both are DTensors (a state
    leaf after an update keeps its layout, as a jitted JAX step's donated
    state does); else ``new`` as it is."""
    if (is_dtensor(new) and is_dtensor(old)
            and tuple(new.placements) != tuple(old.placements)):
        return new.redistribute(old.device_mesh, old.placements)
    return new


# ---------------------------------------------------------------------------
# parameter and state trees
# ---------------------------------------------------------------------------

class NamedSharding(NamedTuple):
    """A mesh and a spec (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def sharding_for(spec: ParamSpec, mesh, rules: Rules | None = None
                 ) -> NamedSharding:
    return NamedSharding(mesh, pspec_for(spec.shape, spec.axes, mesh, rules))


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (a
    NamedTuple keeps its type); anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_shardings(spec_tree, mesh, rules: Rules | None = None):
    """ParamSpec tree -> NamedSharding tree."""
    return _map(lambda s: sharding_for(s, mesh, rules), spec_tree)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``sharding``: each rank keeps its shard. No collective: every
    rank holds the full tensor already."""
    from torch.distributed.tensor import DTensor
    mesh, spec = sharding.mesh, sharding.spec
    coords = mesh.get_coordinate()
    sizes = mesh_shape(mesh)
    names = list(sizes)
    if coords is None:              # a rank outside the mesh holds nothing
        return DTensor.from_local(t.new_empty((0,) * t.ndim), mesh,
                                  sharding.placements, run_check=False,
                                  shape=t.shape,
                                  stride=contiguous_stride(t.shape))
    local = t
    for d, e in enumerate(tuple(spec)):
        axes = _entry_axes(e)
        if not axes:
            continue
        idx = 0
        for a in axes:                      # major first
            idx = idx * sizes[a] + coords[names.index(a)]
        n = _axis_size(sizes, axes)
        local = local.chunk(n, dim=d)[idx]
    return DTensor.from_local(local.contiguous(), mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))


def distribute_tree(tree, shardings):
    """JAX's ``device_put(tree, shardings)``: each tensor leaf of ``tree``
    distributed by its leaf of ``shardings`` (:func:`tree_shardings`)."""
    return _map(distribute, tree, shardings)


def abstract_tree(spec_tree, mesh, rules: Rules | None = None, *,
                  dtype: torch.dtype = torch.float32,
                  dtype_override: torch.dtype | None = None,
                  device: str = "meta"):
    """ParamSpec tree -> DTensors with no data (``device="meta"``, or
    whatever device a fake-tensor mode gives), each laid out by the
    rules: matrices in ``dtype``, the rest in f32 (the port's parameter
    dtypes), every leaf in ``dtype_override`` where given."""
    from torch.distributed.tensor import DTensor

    def mk(s: ParamSpec):
        sh = sharding_for(s, mesh, rules)
        dt = dtype_override or (dtype if s.matrix else torch.float32)
        local = torch.empty(local_shape(s.shape, sh.spec, mesh), dtype=dt,
                            device=device)
        return DTensor.from_local(local, mesh, sh.placements,
                                  run_check=False, shape=torch.Size(s.shape),
                                  stride=contiguous_stride(s.shape))
    return _map(mk, spec_tree)


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# input-batch and cache shardings (activation side)
# ---------------------------------------------------------------------------

def batch_pspec(mesh) -> Any:
    names = mesh_shape(mesh)
    cand = ("pod", "data") if "pod" in names else ("data",)
    return cand if len(cand) > 1 else cand[0]


def shard_batch_specs(specs: Mapping[str, tuple], mesh,
                      rules: Rules | None = None) -> dict:
    """{input name: NamedSharding} for model inputs ``{name: (shape,
    dtype)}`` (``models.batch_specs``).

    tokens/labels (B, S): batch over (pod, data). embeds (B, S, d)
    likewise. positions (3, B, S): batch on dim 1. Falls back to the
    data axis, then to replication, when the batch does not divide."""
    out = {}
    sizes = mesh_shape(mesh)
    bp = batch_pspec(mesh)
    bsz = _axis_size(sizes, _entry_axes(bp))
    for name, (shape, _dtype) in specs.items():
        dims: list[Any] = [None] * len(shape)
        bdim = 1 if name == "positions" else 0
        if shape[bdim] % bsz == 0:
            dims[bdim] = bp
        elif "data" in sizes and shape[bdim] % sizes["data"] == 0:
            dims[bdim] = "data"
        out[name] = NamedSharding(mesh, tuple(dims))
    return out


def batch_from_local(batch: Mapping[str, torch.Tensor], mesh) -> dict:
    """Each rank's share of a global batch as DTensors of the global batch,
    laid out as :func:`shard_batch_specs` lays it: the rank's rows along
    the batch dim are its block along the mesh's batch axes (its rank
    order on a 1-D ("data",) mesh). No collective."""
    from torch.distributed.tensor import DTensor
    n = _axis_size(mesh_shape(mesh), _entry_axes(batch_pspec(mesh)))
    out = {}
    for name, local in batch.items():
        shape = list(local.shape)
        shape[1 if name == "positions" else 0] *= n
        sh = shard_batch_specs({name: (tuple(shape), None)}, mesh)[name]
        out[name] = DTensor.from_local(
            local.contiguous(), mesh, sh.placements, run_check=False,
            shape=torch.Size(shape), stride=contiguous_stride(shape))
    return out


def cache_axes(cfg, leaf_path: str, shape: tuple[int, ...]) -> tuple:
    """Logical axes of one layer's decode-state leaf: the JAX package's
    rule for its stacked leaf (a leading ``"layers"`` dim), without that
    dim."""
    n = len(shape) + 1                             # the JAX stacked rank
    if n == 5 and "cross" not in leaf_path:        # KV cache (B,S,K,hd)
        axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    elif n == 5:                                   # whisper cross (B,Se,K,hd)
        axes = ("layers", "batch", "seq", "kv_heads", "head_dim")
    elif n == 4:                                   # ssm h (B,di,N), conv
        axes = ("layers", "batch", "ssm_inner", None)
    elif n == 3:                                   # shifts (B,d)
        axes = ("layers", "batch", "ssm_inner")
    else:
        axes = ("layers",) + (None,) * (n - 1)
    return axes[1:]


def _state_leaves(state, path: str = ""):
    """(path, leaf) of every leaf of a decode state: NamedTuple fields by
    name, list items by index."""
    if hasattr(state, "_fields"):
        for f in state._fields:
            yield from _state_leaves(getattr(state, f), f"{path}.{f}")
    elif isinstance(state, (list, tuple)):
        for i, c in enumerate(state):
            yield from _state_leaves(c, f"{path}[{i}]")
    else:
        yield path, state


def decode_state_specs(cfg, state, mesh, rules: Rules | None = None) -> dict:
    """{leaf path: spec} of every tensor leaf of a DecodeState or
    WhisperState (the JAX package's ``shard_decode_state`` rules, per
    layer)."""
    rules = rules or DEFAULT_RULES
    out = {}
    for path, leaf in _state_leaves(state):
        if not isinstance(leaf, torch.Tensor):
            continue                        # pos and cache_len: host ints
        shape = tuple(leaf.shape)
        if shape == ():
            out[path] = ()
            continue
        if "rwkv" in cfg.family or cfg.rwkv:
            # rwkv state s: (B,H,dk,dv); shifts (B,d)
            if len(shape) == 4:
                axes = ("batch", "heads", None, None)
            elif len(shape) == 2:
                axes = ("batch", None)
            else:
                axes = cache_axes(cfg, path, shape)
        else:
            axes = cache_axes(cfg, path, shape)
        out[path] = pspec_for(shape, axes, mesh, rules)
    return out


def shard_decode_state(cfg, state, mesh, rules: Rules | None = None):
    """The decode state with every tensor leaf a DTensor laid out by
    :func:`decode_state_specs` (meta leaves stay meta)."""
    specs = decode_state_specs(cfg, state, mesh, rules)

    def walk(node, path: str = ""):
        if hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), f"{path}.{f}")
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, f"{path}[{i}]")
                              for i, c in enumerate(node))
        if path in specs:
            return _distribute_any(node, NamedSharding(mesh, specs[path]))
        return node
    return walk(state)


def _distribute_any(t: torch.Tensor, sharding: NamedSharding):
    """:func:`distribute` for data, a shape-only DTensor for a meta
    tensor."""
    if t.device.type != "meta":
        return distribute(t, sharding)
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(t.shape, sharding.spec, sharding.mesh),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=contiguous_stride(t.shape))
