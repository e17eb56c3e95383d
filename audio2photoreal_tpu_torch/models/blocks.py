"""Transformer building blocks of the FiLM denoiser.

Counterpart of ``audio2photoreal_tpu/models/blocks.py`` (reference:
model/modules/transformer_modules.py:105-268): pre-norm layers whose every
sublayer output is gated by FiLM(t) before the residual add.  The modules
keep the reference's state-dict names (``self_attn.in_proj_weight``,
``multihead_attn``, ``film1.block.1``, ``linear1``, ...), so a released
checkpoint loads as it is.

Rotary is applied to the FULL d_model before the q/k projections, as the
reference does (transformer_modules.py:88,238,252-253).

Dropout follows the JAX package: attention-prob dropout (in the attention
kernel, or Bernoulli on the plain path), after the feed-forward's GELU, and
on every sublayer output before its FiLM gate.  It is active in training
mode (``nn.Module.training``) and draws from the ``generator`` handed down
the call: one seed per call site, as the JAX package folds one key per site.
With ``hash_dropout`` the masks are ``hash_drop_mult``'s position hash, else
Bernoulli draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.kernels.flash_attn import flash_attention, hash_bits
from audio2photoreal_tpu_torch.ops.attention import dot_product_attention
from audio2photoreal_tpu_torch.ops.rotary import RotaryTable, apply_rotary

INT32_MAX = 2**31 - 1


def draw_seed(generator: Optional[torch.Generator], high: int = INT32_MAX) -> int:
    """One seed in [0, high) from ``generator`` (a CPU generator, so the draw
    costs the card nothing; None takes torch's default generator)."""
    return int(torch.randint(0, high, (), generator=generator))


def device_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of ``generator``."""
    return torch.Generator(device=device).manual_seed(draw_seed(generator))


def hash_drop_mult(seed: int, shape, rate: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """The JAX package's ``hash_drop_mult`` (models/blocks.py:56) for a uint32
    ``seed``: Bernoulli(1 - rate) multiplier, 0 or 1/(1 - rate) in ``dtype``,
    from a position hash of (seed, flat index).  Its mix is the flash mask's
    with block 0, the flat index as the row and column 0."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    keep = (hash_bits(seed, 0, idx, 0) >= int(rate * 2**32)).to(dtype)
    one = torch.ones((), dtype=dtype, device=device)
    return keep * (one / torch.tensor(1.0 - rate, dtype=dtype, device=device))


class Dropout(nn.Module):
    """The JAX package's ``make_dropout`` (models/blocks.py:96):
    ``HashDropout`` (:81) with ``hash_dropout``, else ``nn.Dropout``'s
    Bernoulli draw.  The identity in eval mode or at rate 0."""

    def __init__(self, rate: float, hash_dropout: bool = False):
        super().__init__()
        self.rate, self.hash_dropout = rate, hash_dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.hash_dropout:
            seed = draw_seed(generator, 2**32)
            return x * hash_drop_mult(seed, x.shape, self.rate, x.dtype, x.device)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.rate, generator=device_generator(generator, x.device))
        return x * keep / (1.0 - self.rate)


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

    ``flash=True`` sends the attention through the CUDA kernels
    (``kernels/flash_attn.py``) when there is no bias and both sequence axes
    reach ``FLASH_MIN_LEN``, exactly the JAX package's gate.  In training,
    ``dropout`` drops attention probabilities: inside the kernels from one
    int32 seed per call (blocks.py:184), else by a Bernoulli draw."""

    FLASH_MIN_LEN = 128

    def __init__(self, dim: int, heads: int, flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.flash, self.dropout = dim, heads, flash, dropout
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
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        q = self._proj(q_in, 0)
        B, Tq, _ = q.shape
        rate = self.dropout if self.training else 0.0
        if self.flash and bias is None and min(Tq, k.shape[1]) >= self.FLASH_MIN_LEN:
            qkv = [self._split(x).contiguous() for x in (q, k, v)]
            if rate > 0.0:
                out = flash_attention(*qkv, None, False, rate, draw_seed(generator))
            else:
                out = flash_attention(*qkv)
        else:
            gen = device_generator(generator, q.device) if rate > 0.0 else None
            out = dot_product_attention(self._split(q), self._split(k), self._split(v), bias, rate, gen)
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, self.dim))

    def forward(self, q_in, k_in, v_in, bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        k, v = self.project_kv(k_in, v_in)
        return self.attend(q_in, k, v, bias, generator)


def _maybe_rotate(x: torch.Tensor, rotary: Optional[RotaryTable]) -> torch.Tensor:
    return apply_rotary(x, rotary) if rotary is not None else x


class FiLMDecoderLayer(nn.Module):
    """self-attn -> FiLM, cross-attn (audio) -> FiLM, [cross-attn 2 (keyframes)
    -> FiLM], feed-forward -> FiLM; all pre-norm with residuals."""

    def __init__(self, dim: int, heads: int, ff_size: int, use_cm: bool = False,
                 flash: bool = False, dropout: float = 0.0, hash_dropout: bool = False):
        super().__init__()
        self.use_cm = use_cm
        self.self_attn = MultiHeadAttention(dim, heads, flash, dropout)
        self.multihead_attn = MultiHeadAttention(dim, heads, flash, dropout)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.film1 = DenseFiLM(dim)
        self.film2 = DenseFiLM(dim)
        self.film3 = DenseFiLM(dim)
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)
        self.ff_drop = Dropout(dropout, hash_dropout)  # after the GELU
        self.drop = Dropout(dropout, hash_dropout)  # on each sublayer output
        if use_cm:
            # the keyframe memory is ~20 tokens: never built with the kernel
            self.multihead_attn2 = MultiHeadAttention(dim, heads, dropout=dropout)
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
        generator: Optional[torch.Generator] = None,  # dropout draws (training)
    ) -> torch.Tensor:
        g = generator
        h = self.norm1(x)
        qk = _maybe_rotate(h, rotary)
        h = self.drop(self.self_attn(qk, qk, h, generator=g), g)
        x = x + featurewise_affine(h, self.film1(t))

        h = self.norm2(x)
        h = self.drop(self.multihead_attn.attend(_maybe_rotate(h, rotary), *cross_kv, generator=g), g)
        x = x + featurewise_affine(h, self.film2(t))

        if self.use_cm:
            h = self.norm2a(x)
            q = _maybe_rotate(h, rotary)
            h = self.drop(self.multihead_attn2(q, _maybe_rotate(memory2, rotary), memory2, generator=g), g)
            x = x + featurewise_affine(h, self.film2a(t))

        h = self.ff_drop(F.gelu(self.linear1(self.norm3(x))), g)  # erf GELU, as the reference
        h = self.drop(self.linear2(h), g)
        return x + featurewise_affine(h, self.film3(t))
