"""Batched serving engine: prefill + ring-cache decode.

Requests are grouped into fixed-shape batches (padded to the bucket),
prefilled once (building ring KV caches with decode headroom), then
decoded step by step with per-request EOS masking; finished rows keep
decoding into padding but are masked out of the results (slot reuse across
bucket boundaries is the scheduler's job, serve/scheduler.py).

The engine serves every ported family: the decode state it carries
between steps is each layer's (a KV ring for attention, the Mamba h and
conv tail, the RWKV wkv state and shifts; ``models/transformer.py``).
Requests are token ids, as the JAX package's engine takes them: a model
on embedding inputs (qwen2-vl's backbone, whose vision frontend is a
stub) is refused, and is driven through ``ModelBundle.prefill`` /
``decode`` with its embeddings and M-RoPE positions; so is whisper's
encoder-decoder, whose prefill also takes the audio frames (ROADMAP.md).

The engine runs on the device its parameters live on. Each ``generate``
call is one ``serve.generate`` span (``obs/trace.py``) carrying the batch
shape, the decode steps taken, and two stages: ``prefill`` (up to the
first token on the host) and ``decode`` (the rest of the loop). Each step
reads its tokens back to the host, so both walls end in a device sync. The
span lands in the flight recorder's capped ring and the
``span.serve.generate`` histogram.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import build
from ..models.transformer import FwdOpts
from ..obs.trace import span
from .sampling import sample


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1               # -1: never stop early
    pad_id: int = 0


def check_token_model(cfg: ModelConfig) -> None:
    """Raise for a model on embedding inputs or an encoder-decoder, which
    the engine does not serve (its prefill takes token ids alone)."""
    if cfg.input_mode == "embeddings":
        raise NotImplementedError(
            f"{cfg.name}: the engine serves token models; an embeddings "
            "model runs through ModelBundle.prefill / decode (ROADMAP.md)")
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the engine serves decoder-only token models; an "
            "encoder-decoder takes its audio frames (enc_embeds) through "
            "ModelBundle.prefill / decode (ROADMAP.md)")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 scfg: ServeConfig | None = None,
                 run: RunConfig | None = None):
        check_token_model(cfg)
        # fresh default per engine: a shared ServeConfig() instance would
        # leak one caller's knob tweaks into every other engine
        self.cfg, self.scfg = cfg, scfg if scfg is not None else ServeConfig()
        self.params = params
        self.device = params["embed"]["tok"].device
        self.bundle = build(cfg)
        self.opts = FwdOpts(attn_impl=(run or RunConfig()).attn_impl)
        self.stats = {"requests": 0, "prefill_tokens": 0, "decode_tokens": 0}

    def generate(self, prompts: np.ndarray, *, seed: int = 0) -> np.ndarray:
        """prompts: (B, S) int32 (left-aligned, pad with pad_id). Returns
        (B, max_new_tokens) generated ids (pad after EOS)."""
        b, s = prompts.shape
        with span("serve.generate", batch=b, seq=s) as sp:
            t0 = time.perf_counter()
            pad_to = s + self.scfg.max_new_tokens
            tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                     device=self.device)
            logits, state = self.bundle.prefill(
                self.params, {"tokens": tokens}, self.opts, pad_to=pad_to)
            self.stats["requests"] += b
            self.stats["prefill_tokens"] += b * s
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            out = np.full((b, self.scfg.max_new_tokens), self.scfg.pad_id,
                          np.int32)
            done = np.zeros(b, bool)
            t_first = None
            steps = 0
            for t in range(self.scfg.max_new_tokens):
                tok = sample(logits, gen, temperature=self.scfg.temperature,
                             top_k=self.scfg.top_k)
                ids = tok[:, 0].cpu().numpy()
                if t_first is None:
                    t_first = time.perf_counter()
                ids = np.where(done, self.scfg.pad_id, ids)
                out[:, t] = ids
                done |= (ids == self.scfg.eos_id)
                self.stats["decode_tokens"] += int((~done).sum())
                if done.all():
                    break
                nxt = torch.as_tensor(ids[:, None].astype(np.int64),
                                      device=self.device)
                logits, state = self.bundle.decode(self.params, nxt, state)
                steps += 1
            t_end = time.perf_counter()
            sp.fields["decode_steps"] = steps
            sp.add_stage("prefill", t_first - t0)
            sp.add_stage("decode", t_end - t_first)
        return out
