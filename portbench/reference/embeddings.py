"""Positional embeddings: the denoiser's time embedding (model/utils.py:67-81
SinusoidalPosEmb) and the lip regressor's absolute positions."""

from __future__ import annotations

import math

import torch


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
