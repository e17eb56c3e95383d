"""Plain softmax attention: logits and softmax in f32, masks as additive
-1e9 biases, causal alignment ``j <= i + (Tk - Tq)``, Bernoulli dropout of
the probabilities from an explicit generator, made for the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference import rows as sharding

NEG_INF = -1e9  # large-negative, not -inf: a fully masked row stays NaN-free


def causal_bias(q_len: int, k_len: int, device=None) -> torch.Tensor:
    """[q_len, k_len] lower-triangular additive mask."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(j <= i + (k_len - q_len), zero, NEG_INF)


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Tq, Dh]
    k: torch.Tensor,  # [B, H, Tk, Dh]
    v: torch.Tensor,  # [B, H, Tk, Dh]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk]
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,  # on q's device; draws the mask
) -> torch.Tensor:
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        # made for the global batch under a data-parallel step (parallel/sharding.py)
        keep = sharding.draw_global(
            lambda s: probs.new_empty(s).bernoulli_(1.0 - dropout_rate, generator=generator), probs.shape)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.matmul(probs, v)
