"""Plain softmax attention.

Counterpart of ``audio2photoreal_tpu/ops/attention.py``: logits and softmax
in f32, masks as additive -1e9 biases, causal alignment ``j <= i + (Tk - Tq)``.
This is the path every attention takes when the layer was not built with
``flash`` or the flash gate is closed (``models/blocks.py``), and the plain
version of the attention kernel (``kernels/flash_attn.py``).  Training drops
probabilities with a Bernoulli mask drawn from an explicit generator, as the
JAX package draws its mask from an explicit key (``ops/attention.py:52-54``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative, not -inf: a fully masked row stays NaN-free


def causal_bias(q_len: int, k_len: int, device=None) -> torch.Tensor:
    """[q_len, k_len] lower-triangular additive mask."""
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(j <= i + (k_len - q_len), zero, NEG_INF)


def padding_bias(valid: torch.Tensor) -> torch.Tensor:
    """Key validity [B, K] (1 = valid) -> additive bias [B, 1, 1, K]."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid[:, None, None, :] > 0, zero, NEG_INF)


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
        keep = torch.empty_like(probs).bernoulli_(1.0 - dropout_rate, generator=generator)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.matmul(probs, v)
