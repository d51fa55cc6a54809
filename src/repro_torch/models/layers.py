"""Parameter shapes and their initialization, plus the shared layers
(norms, RoPE, MLP, embedding and head) as functions on tensors.

The JAX package keeps every parameter as an f32 master and casts the
matrix weights to the activation dtype at each use. Rounding to nearest
even gives the same values once as every time, so the port casts the
matrix weights once, when they are made or loaded, and keeps them in the
activation dtype (half the bytes a decode step reads in bf16). Norm scales
and biases stay f32: the norms apply them in f32.

``ParamSpec`` mirrors the JAX package's: the shape, the init rule and the
logical axis of each dim (``axes``), which ``sharding/rules.py`` maps onto
a mesh. The JAX package stacks each position of the layer pattern under a
leading ``"layers"`` axis; the port keeps one leaf per layer, so a port
leaf's axes are the JAX leaf's without that first entry (which the rules
map to no mesh axis anyway). The port's own init draws
from a seeded ``torch.Generator``: normal with std ``1 / sqrt(fan_in)``
(0.02 for the embedding), ``fan_in`` the second-to-last dim as in the JAX
package, except for the 3-D attention weights, where it is the size of
the contracted dims (d_model for wq/wk/wv, heads x head_dim for wo). The
JAX package takes the head count (wq) and head_dim (wo) there, which at
llama3.2-1b's width gives q and k entries of std 8 and attention logits of
std about 128: every softmax is nearly one-hot, and a rounding in the last
bit of a logit can change which key wins, so two devices (or bf16 and
f32) give different answers after 16 layers. JAX's seeded init is not
reproducible across processes anyway (it folds Python's salted ``hash``
of each parameter path into the key), so the port does not try to match
it; weights that must match come across from a parameter tree
(``models/weights.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.rules import is_dtensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | embed | small
    matrix: bool = True               # kept in the activation dtype
    fan_in: int = 0                   # 0: the second-to-last dim
    scale: float = 1.0                # times the std, as the JAX package's
    axes: tuple = ()                  # logical axis name per dim

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not fit shape "
                             f"{self.shape}")

    @property
    def std(self) -> float:
        if self.init == "embed":
            return self.scale * 0.02
        if self.init == "small":
            return self.scale * 0.01
        fan_in = self.fan_in or (self.shape[-2] if len(self.shape) >= 2
                                 else self.shape[-1])
        return self.scale / float(np.sqrt(max(fan_in, 1)))


#: the most elements drawn in f32 at once: a parameter is drawn a slice
#: of its leading dim at a time (an expert stack of kimi-k2 is 5.6e9
#: elements, 22.5 GB in f32), and a smaller one in a single slice
DRAW_SLICE = 1 << 28


def init_param(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    """One parameter: drawn in f32 (as the JAX package's masters) a
    slice of the leading dim at a time, each slice cast into the
    ``dtype`` tensor."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    row_elems = max(1, out.numel() // max(1, spec.shape[0]))
    rows = max(1, DRAW_SLICE // row_elems)
    for r0 in range(0, spec.shape[0], rows):
        part = out[r0:r0 + rows]
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=device)
        part.copy_(x.mul_(spec.std))
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_spec(cfg) -> dict:
    if cfg.norm == "layernorm_np":     # OLMo: non-parametric LN
        return {}
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), "ones", matrix=False,
                                   axes=("embed",)),
                "bias": ParamSpec((cfg.d_model,), "zeros", matrix=False,
                                  axes=("embed",))}
    return {"scale": ParamSpec((cfg.d_model,), "ones", matrix=False,
                               axes=("embed",))}


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm | layernorm | layernorm_np over the last dim, in f32 (the
    f32 scale and bias applied in f32), cast back to ``x``'s dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S), or (3, B, S) for M-RoPE.
    Rotates the two halves of the head dim (not interleaved pairs), in
    f32.

    M-RoPE (qwen2-vl): the D/2 frequency slots are split into
    (temporal, height, width) ``sections``, each rotated by its own row
    of position ids."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), device=x.device)
    if sections is None:
        angles = positions[..., None].float() * freqs      # (B, S, D/2)
    else:
        if positions.ndim != 3 or positions.shape[0] != len(sections):
            raise ValueError(f"M-RoPE needs ({len(sections)}, B, S) "
                             f"position ids, got {tuple(positions.shape)}")
        if sum(sections) != freqs.shape[0]:
            raise ValueError(f"M-RoPE sections {sections} do not cover "
                             f"head_dim / 2 = {freqs.shape[0]}")
        angles = torch.cat([positions[i][..., None].float() * f
                            for i, f in enumerate(freqs.split(
                                list(sections)))], dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or plain)
# ---------------------------------------------------------------------------

def mlp_spec(cfg, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    s = {"wi": ParamSpec((cfg.d_model, d_ff), axes=("embed", "mlp")),
         "wo": ParamSpec((d_ff, cfg.d_model), axes=("mlp", "embed"))}
    if cfg.mlp_gated:
        s["wg"] = ParamSpec((cfg.d_model, d_ff), axes=("embed", "mlp"))
    return s


def _act(cfg):
    if cfg.act == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_gated:
        h = _act(cfg)(x @ p["wg"]) * h
    else:
        h = _act(cfg)(h)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_spec(cfg) -> dict:
    # "embed_tbl", not "embed": the JAX package keeps the table's d_model
    # dim off the data axis (vocab over model gives vocab-sharded logits)
    s = {"tok": ParamSpec((cfg.vocab, cfg.d_model), "embed",
                          axes=("vocab", "embed_tbl"))}
    if not cfg.tie_embeddings:
        s["head"] = ParamSpec((cfg.d_model, cfg.vocab),
                              axes=("embed_tbl", "vocab"))
    return s


def apply_embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p["tok"]):
        return _embed_rows(p["tok"], tokens)
    return p["tok"][tokens]


def _embed_rows(tok, tokens):
    """The lookup by ``local_map`` under a mesh: each rank's token ids,
    laid out as they are, against the whole table (DTensor's own
    strategies refuse ids sharded over two mesh dims, the batch over
    ("pod", "data"), and lay the table's gradient out over a dim they
    cannot name). The table's gradient is a partial sum over each mesh
    dim that splits the ids."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tok.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    ids = list(tokens.placements)
    grad = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in ids]
    whole = [Replicate()] * mesh.ndim
    return local_map(lambda t, i: t[i], out_placements=ids,
                     in_placements=(whole, ids),
                     in_grad_placements=(grad, ids), device_mesh=mesh,
                     redistribute_inputs=True)(tok, tokens)


def apply_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    w = p["head"] if "head" in p else p["tok"].T
    return x @ w
