"""Error-feedback int8 gradient compression.

The JAX package's mechanics for the cross-pod reduction:

    q, scale = quantize(g + e)        # per-tensor symmetric int8
    e'       = (g + e) - dequantize(q, scale)   # residual carried forward
    g_hat    = mean over pods of dequantize(q, scale)

On one card the quantize / dequantize pair runs in the train step and the
residual rides in the state; the cross-pod mean (``podwise_mean``) waits
for distribution (ROADMAP.md Queue 1 item 3).
"""
from __future__ import annotations

import torch

from .tree import stacked_groups, tree_leaves, tree_map, tree_unflatten


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


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
