"""Rotary position embeddings.

Counterpart of ``audio2photoreal_tpu/ops/rotary.py`` (reference:
model/modules/rotary_embedding_torch.py:84-138).  The reference rotates the
FULL d_model before the q/k projections (transformer_modules.py:88,238,
252-253), not each head after the split; the models here do the same, which
keeps released checkpoints loadable.  Frequencies are pairwise interleaved.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class RotaryTable(NamedTuple):
    cos: torch.Tensor  # [max_len, dim]
    sin: torch.Tensor  # [max_len, dim]


def make_rotary_table(
    dim: int,
    max_len: int,
    theta: float = 10_000.0,
    device: Optional[Union[str, torch.device]] = None,
) -> RotaryTable:
    """Pairwise-interleaved frequency table ('lang' freqs_for)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freqs = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs).repeat_interleave(2, dim=-1)  # [max_len, dim]
    return RotaryTable(cos=torch.cos(angles), sin=torch.sin(angles))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairs (x1, x2) -> (-x2, x1), pairwise interleaved."""
    p = x.unflatten(-1, (-1, 2))
    return torch.stack([-p[..., 1], p[..., 0]], dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, table: RotaryTable, offset: int = 0) -> torch.Tensor:
    """Rotate the last dim of x [..., T, D] at positions offset..offset+T-1."""
    T, D = x.shape[-2], x.shape[-1]
    cos = table.cos[offset : offset + T, :D].to(x.dtype)
    sin = table.sin[offset : offset + T, :D].to(x.dtype)
    return x * cos + _rotate_half(x) * sin
