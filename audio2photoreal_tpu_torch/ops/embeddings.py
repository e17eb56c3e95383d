"""Positional / timestep embeddings.

Counterpart of ``audio2photoreal_tpu/ops/embeddings.py`` for the embedding
the denoiser uses (model/utils.py:67-81 SinusoidalPosEmb).
"""

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
