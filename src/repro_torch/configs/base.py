"""Config system: ModelConfig (architecture), ShapeConfig (assigned input
shapes), RunConfig (parallelism/optimizer/runtime). The port's own copy of
``repro.configs.base``: one module per ported architecture lives next to
this file, and `get_config(arch_id)` resolves them. Every assigned
architecture has one. The Meta-pipe encoder (``metapipe.py``) is no
assigned architecture and is imported by module.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1              # layer l is MoE iff l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    # --- block structure ---
    norm: str = "rmsnorm"           # rmsnorm | layernorm | layernorm_np (OLMo)
    act: str = "silu"
    mlp_gated: bool = True
    tie_embeddings: bool = False
    # --- hybrid / ssm ---
    attn_every: int = 1             # layer l is attention iff l % attn_every == attn_offset
    attn_offset: int = 0            # (else Mamba); rwkv=True overrides all layers
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv: bool = False
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings (stub frontend)
    # --- modality stub: tokens | embeddings (vlm/audio backbones) ---
    input_mode: str = "tokens"
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def is_moe_layer(self, l: int) -> bool:
        return self.n_experts > 0 and l % self.moe_every == self.moe_offset

    def is_attn_layer(self, l: int) -> bool:
        if self.rwkv:
            return False
        return l % self.attn_every == self.attn_offset

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is sub-quadratic in context (SSM/hybrid)."""
        return self.rwkv or self.attn_every > 1

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND rooflines."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        enc_layers = self.encoder_layers
        for l in range(self.n_layers + enc_layers):
            is_enc = l >= self.n_layers
            if self.rwkv:
                # time-mix: r,k,v,g,o (5 d^2) + small loras/decay; channel-mix
                total += 5 * d * d + (2 * d * self.d_ff + d * d) + 6 * 32 * 2 * d
                continue
            # mixer
            if is_enc or self.is_attn_layer(l):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if is_enc:
                    total += q + kv + o  # decoder cross-attn mirrors per enc layer
            else:  # mamba
                di = self.ssm_expand * d
                total += 2 * d * di + di * d + di * (2 * self.ssm_state) \
                    + di * self.ssm_conv + di  # in/out proj, B/C, conv, dt
                total += max(1, d // 16) * (d + di)
            # ffn
            fmul = 3 if self.mlp_gated else 2
            if not is_enc and self.is_moe_layer(l):
                total += self.n_experts * fmul * d * self.d_ff_expert
                total += d * self.n_experts  # router
            else:
                total += fmul * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        fmul = 3 if self.mlp_gated else 2
        n_moe_layers = sum(1 for l in range(self.n_layers) if self.is_moe_layer(l))
        expert_params = n_moe_layers * self.n_experts * fmul * self.d_model * self.d_ff_expert
        active_expert = n_moe_layers * self.top_k * fmul * self.d_model * self.d_ff_expert
        return full - expert_params + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str          # train | prefill | decode


#: the assigned input-shape set (same four for every LM arch)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs (launcher-owned, not architecture-owned): the JAX
    package's training knobs that act in the port, with its defaults.
    Its other four have no counterpart here: ``attn_chunk`` (the flash
    kernels pick their own tiles), ``scan_layers`` and ``unroll`` (the
    layer loop is a Python loop; the JAX package scans stacked layers
    and unrolls the scan for its dry run), and ``z_loss`` (the JAX
    package's step reads no such field either: ``loss_fn`` takes its
    coefficient as ``z_coef``, 1e-4)."""
    optimizer: str = "adamw"         # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0              # 0 = no gradient accumulation
    remat: str = "nothing_saveable"  # nothing_saveable | dots | none
    attn_impl: str = "chunked"       # xla | chunked (the flash kernel)
    grad_compress: bool = False      # int8 error-feedback compression


ARCH_IDS = [
    "grok-1-314b", "kimi-k2-1t-a32b", "llama3.2-1b", "qwen2-0.5b",
    "qwen1.5-4b", "olmo-1b", "qwen2-vl-72b", "whisper-medium",
    "jamba-v0.1-52b", "rwkv6-7b",
]


#: architectures with a config module in the port: every assigned one
PORTED = ("grok-1-314b", "jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama3.2-1b",
          "olmo-1b", "qwen1.5-4b", "qwen2-0.5b", "qwen2-vl-72b", "rwkv6-7b",
          "whisper-medium")


def _module_for(arch_id: str) -> str:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; one of {ARCH_IDS}")
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_for(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_module_for(arch_id)}")
    return mod.SMOKE


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The assigned shape cells for an architecture (with documented skips)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out
