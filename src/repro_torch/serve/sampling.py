"""Token sampling for the serving engine."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, gen: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int32. Greedy (first maximum, as
    ``jnp.argmax``) at temperature 0; otherwise a categorical draw from
    ``gen``, which matches the JAX package's draws only in distribution."""
    logits = logits[:, -1, :]
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)[:, None]
    logits = logits / temperature
    if top_k > 0:
        cut = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cut, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
