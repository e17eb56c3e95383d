"""Positional / timestep embeddings.

Counterpart of ``audio2photoreal_tpu/ops/embeddings.py``: the
denoiser's time embedding (model/utils.py:67-81 SinusoidalPosEmb), the lip
regressor's absolute positions, and the guided-diffusion timestep embedding
(diffusion/nn.py:124), which no ported model calls.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim]: cos then sin, a zero
    column for an odd ``dim``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def sinusoidal_pos_emb(positions: torch.Tensor, dim: int, base: float = 10_000.0) -> torch.Tensor:
    """sin then cos over positions, [...] -> [..., dim]."""
    half = dim // 2
    scale = math.log(base) / max(half - 1, 1)
    freqs = torch.exp(-scale * torch.arange(half, dtype=torch.float32, device=positions.device))
    args = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def absolute_pos_encoding(seq_len: int, dim: int, base: float = 10_000.0, device=None) -> torch.Tensor:
    """[T, dim] table of the standard batch-first positional encoding
    (transformer_modules.py:281-302): sin at even, cos at odd channels."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(base) / dim))
    pe = torch.zeros((seq_len, dim), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: dim // 2])
    return pe
