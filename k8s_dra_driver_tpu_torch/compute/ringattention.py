"""Exact attention over whole sequences, unsharded.

``reference_attention`` is the JAX package's function of the same name
(``compute/ringattention.py``): f32 scores scaled by 1/sqrt(d), an optional
causal mask (key j hidden from query row i when j > i), softmax, and the
output in q's dtype. In the port it is the plain version of the
flash-attention kernel: the CPU path of ``flash_attention`` and the
kernel's oracle on the card. The ring itself, which shards the sequence
across devices, waits for the multi-GPU compute plane.
"""

from __future__ import annotations

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """[b, h, S, d] x [b, h, S, d] x [b, h, S, dv] -> [b, h, S, dv] in q's
    dtype, with the [S, S] scores materialized in f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(scores.shape[-2:], dtype=torch.bool,
                          device=scores.device).tril()
        scores.masked_fill_(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
