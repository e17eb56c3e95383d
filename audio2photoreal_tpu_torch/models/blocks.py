"""Transformer building blocks of the FiLM denoiser.

Counterpart of ``audio2photoreal_tpu/models/blocks.py`` (reference:
model/modules/transformer_modules.py:105-268): pre-norm layers whose every
sublayer output is gated by FiLM(t) before the residual add.  The modules
keep the reference's state-dict names (``self_attn.in_proj_weight``,
``multihead_attn``, ``film1.block.1``, ``linear1``, ...), so a released
checkpoint loads as it is.

Rotary is applied to the FULL d_model before the q/k projections, as the
reference does (transformer_modules.py:88,238,252-253).

Inference only: dropout is the identity at sampling time and is left out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention
from audio2photoreal_tpu_torch.ops.attention import dot_product_attention
from audio2photoreal_tpu_torch.ops.rotary import RotaryTable, apply_rotary


class DenseFiLM(nn.Module):
    """t-vector [B, D] -> (scale, shift), each [B, 1, D]; ``block`` is the
    reference's Sequential(Mish, Linear)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(nn.Mish(), nn.Linear(dim, dim * 2))

    def forward(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scale, shift = self.block(t)[:, None, :].chunk(2, dim=-1)
        return scale, shift


def featurewise_affine(x: torch.Tensor, scale_shift) -> torch.Tensor:
    scale, shift = scale_shift
    return (scale + 1.0) * x + shift


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed ``in_proj_weight``
    [3D, D] for q, k, v and ``out_proj``) with separate q / kv inputs.

    ``flash=True`` sends the attention through the CUDA kernel
    (``kernels/flash_attn.py``) when there is no bias and both sequence axes
    reach ``FLASH_MIN_LEN``, exactly the JAX package's gate."""

    FLASH_MIN_LEN = 128

    def __init__(self, dim: int, heads: int, flash: bool = False):
        super().__init__()
        self.dim, self.heads, self.flash = dim, heads, flash
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        D = self.dim
        return F.linear(x, self.in_proj_weight[i * D : (i + 1) * D],
                        self.in_proj_bias[i * D : (i + 1) * D])

    def _split(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, H, T, Dh]
        return x.unflatten(-1, (self.heads, -1)).transpose(1, 2)

    def project_kv(self, k_in: torch.Tensor, v_in: torch.Tensor):
        return self._proj(k_in, 1), self._proj(v_in, 2)

    def attend(
        self,
        q_in: torch.Tensor,  # [B, Tq, D] (pre-projection)
        k: torch.Tensor,  # [B, Tk, D] (already projected)
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        q = self._proj(q_in, 0)
        B, Tq, _ = q.shape
        if self.flash and bias is None and min(Tq, k.shape[1]) >= self.FLASH_MIN_LEN:
            out = flash_attention(*(self._split(x).contiguous() for x in (q, k, v)))
        else:
            out = dot_product_attention(self._split(q), self._split(k), self._split(v), bias)
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, self.dim))

    def forward(self, q_in, k_in, v_in, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.project_kv(k_in, v_in)
        return self.attend(q_in, k, v, bias)


def _maybe_rotate(x: torch.Tensor, rotary: Optional[RotaryTable]) -> torch.Tensor:
    return apply_rotary(x, rotary) if rotary is not None else x


class FiLMDecoderLayer(nn.Module):
    """self-attn -> FiLM, cross-attn (audio) -> FiLM, [cross-attn 2 (keyframes)
    -> FiLM], feed-forward -> FiLM; all pre-norm with residuals."""

    def __init__(self, dim: int, heads: int, ff_size: int, use_cm: bool = False,
                 flash: bool = False):
        super().__init__()
        self.use_cm = use_cm
        self.self_attn = MultiHeadAttention(dim, heads, flash)
        self.multihead_attn = MultiHeadAttention(dim, heads, flash)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.film1 = DenseFiLM(dim)
        self.film2 = DenseFiLM(dim)
        self.film3 = DenseFiLM(dim)
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)
        if use_cm:
            # the keyframe memory is ~20 tokens: never built with the kernel
            self.multihead_attn2 = MultiHeadAttention(dim, heads)
            self.norm2a = nn.LayerNorm(dim, eps=1e-5)
            self.film2a = DenseFiLM(dim)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        t: torch.Tensor,  # [B, D] FiLM conditioning vector
        cross_kv: Tuple[torch.Tensor, torch.Tensor],  # projected audio-memory K, V [B, Tm, D]:
        # the denoiser projects all layers' cross K/V over the shared memory at once
        memory2: torch.Tensor,  # [B, Tk, D] keyframe tokens (use_cm layers)
        rotary: Optional[RotaryTable] = None,
    ) -> torch.Tensor:
        h = self.norm1(x)
        qk = _maybe_rotate(h, rotary)
        h = self.self_attn(qk, qk, h)
        x = x + featurewise_affine(h, self.film1(t))

        h = self.norm2(x)
        h = self.multihead_attn.attend(_maybe_rotate(h, rotary), *cross_kv)
        x = x + featurewise_affine(h, self.film2(t))

        if self.use_cm:
            h = self.norm2a(x)
            q = _maybe_rotate(h, rotary)
            h = self.multihead_attn2(q, _maybe_rotate(memory2, rotary), memory2)
            x = x + featurewise_affine(h, self.film2a(t))

        h = self.linear2(F.gelu(self.linear1(self.norm3(x))))  # erf GELU, as the reference
        return x + featurewise_affine(h, self.film3(t))
