"""The blocks of the FiLM denoiser, the guide LM and the lip regressor, in
plain PyTorch: a frozen copy of the measured package's blocks, in which the
attention that the package sends to its kernels (``flash``, no bias, both
sequence axes at least ``FLASH_MIN_LEN``) is the einsum attention with the
hash dropout mask written out (``hashmask.py``).  Parameters stay f32 and
are cast per call to the compute dtype; norms compute in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.hashmask import attention as hash_attention, hash_bits, resolve_block_q, shard_seed
from portbench.reference.attention import dot_product_attention
from portbench.reference.rotary import RotaryTable, apply_rotary
from portbench.reference import rows as sharding

INT32_MAX = 2**31 - 1


def kept(owner: nn.Module, key, params, dtype: torch.dtype, make):
    """``make()``, a tensor (or tuple of tensors) in ``dtype`` made from the
    parameters ``params`` of ``owner``: a cast, a stack.  Under autograd
    made fresh, so the gradient reaches the f32 parameters; without it
    (sampling) kept on ``owner`` under ``key`` until one of ``params``
    changes in place or moves, so a DDIM loop makes it once instead of once
    a step."""
    if torch.is_grad_enabled():
        return make()
    tag = (dtype, *((p._version, p.data_ptr(), p.device) for p in params))
    casts = owner.__dict__.setdefault("_casts", {})
    hit = casts.get(key)
    if hit is None or hit[0] != tag:
        hit = casts[key] = (tag, make())
    return hit[1]


def cast_param(owner: nn.Module, key, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` (a parameter of ``owner``, or a view of one) in ``dtype``, kept
    as ``kept`` keeps it."""
    if t.dtype == dtype:
        return t
    return kept(owner, key, (t,), dtype, lambda: t.to(dtype))


def linear(mod: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``Dense(dtype=...)``: x, the weight and the bias in ``dtype``
    (the sums inside the product in f32)."""
    bias = None if mod.bias is None else cast_param(mod, "bias", mod.bias, dtype)
    return F.linear(x.to(dtype), cast_param(mod, "weight", mod.weight, dtype), bias)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's ``LayerNorm(dtype=...)``: statistics and affine in f32, the
    result cast once to ``dtype``.  (CUDA's layer_norm refuses a bf16 input
    with f32 parameters, so the input is widened first.)"""
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps).to(dtype)


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


def _empty_in_layout_of(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of ``shape`` whose dims lie in memory in ``x``'s order
    (``empty_like`` at another size), so a draw fills it as it fills ``x``."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return x.new_empty([shape[d] for d in order]).permute(*[order.index(d) for d in range(x.dim())])


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
            start, _ = sharding.rows(x.shape[0])
            seed = shard_seed(draw_seed(generator, 2**32), row_offset=start * math.prod(x.shape[1:]))
            return x * hash_drop_mult(seed, x.shape, self.rate, x.dtype, x.device)
        gen = device_generator(generator, x.device)
        keep = sharding.draw_global(lambda s: _empty_in_layout_of(x, s).bernoulli_(1.0 - self.rate, generator=gen),
                                    x.shape)
        return x * keep / (1.0 - self.rate)


class DenseFiLM(nn.Module):
    """t-vector [B, D] -> (scale, shift), each [B, 1, D] in ``dtype``;
    ``block`` is the reference's Sequential(Mish, Linear), the Mish in t's
    dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(nn.Mish(), nn.Linear(dim, dim * 2))

    def forward(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.from_mish(F.mish(t))

    def from_mish(self, mish_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` given Mish(t), which a layer computes once for all
        its FiLM blocks."""
        scale, shift = linear(self.block[1], mish_t, self.dtype)[:, None, :].chunk(2, dim=-1)
        return scale, shift


def featurewise_affine(x: torch.Tensor, scale_shift) -> torch.Tensor:
    scale, shift = scale_shift
    return (scale + 1.0) * x + shift


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed ``in_proj_weight``
    [3D, D] for q, k, v and ``out_proj``) with separate q / kv inputs.

    ``flash=True`` marks the attention the measured package sends to its
    kernels (no bias, both sequence axes at least ``FLASH_MIN_LEN``); here
    it takes the plain attention with the kernels' hash dropout mask, from
    one seed per call, and any other attention a Bernoulli draw.  A
    self-attention (q and k from one tensor) projects q and k as one [D, 2D]
    product, as the JAX package does (blocks.py:206-222).  Projections and
    attention run in ``dtype``."""

    FLASH_MIN_LEN = 128

    def __init__(self, dim: int, heads: int, flash: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.flash, self.dropout, self.dtype = dim, heads, flash, dropout, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)

    def _proj(self, x: torch.Tensor, i: int, n: int = 1) -> torch.Tensor:
        """x through the projections i .. i+n-1 of the packed weight, as one product."""
        D, dt = self.dim, self.dtype
        return F.linear(x.to(dt), cast_param(self, ("w", i, n), self.in_proj_weight[i * D : (i + n) * D], dt),
                        cast_param(self, ("b", i, n), self.in_proj_bias[i * D : (i + n) * D], dt))

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
        return self._attend_projected(self._proj(q_in, 0), k, v, bias, generator)

    def _attend_projected(self, q, k, v, bias=None, generator=None) -> torch.Tensor:
        B, Tq, _ = q.shape
        rate = self.dropout if self.training else 0.0
        if self.flash and bias is None and min(Tq, k.shape[1]) >= self.FLASH_MIN_LEN:
            qkv = [self._split(x) for x in (q, k, v)]  # strided views: the kernel reads them as they are
            if rate > 0.0:
                start, _ = sharding.rows(B)  # the mask's block (b·H + h)·nj + q-block at this rank's global b
                nj = -(-Tq // resolve_block_q(Tq, k.shape[1]))
                out = hash_attention(*qkv, rate,
                                     shard_seed(draw_seed(generator), block_offset=start * self.heads * nj))
            else:
                out = hash_attention(*qkv)
        else:
            gen = device_generator(generator, q.device) if rate > 0.0 else None
            out = dot_product_attention(self._split(q), self._split(k), self._split(v), bias, rate, gen)
        return linear(self.out_proj, out.transpose(1, 2).reshape(B, Tq, self.dim), self.dtype)

    def forward(self, q_in, k_in, v_in, bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if q_in is k_in:  # self-attention: q and k as one product
            q, k = self._proj(q_in, 0, 2).split(self.dim, dim=-1)
            return self._attend_projected(q, k, self._proj(v_in, 2), bias, generator)
        k, v = self.project_kv(k_in, v_in)
        return self.attend(q_in, k, v, bias, generator)


def _maybe_rotate(x: torch.Tensor, rotary: Optional[RotaryTable], offset: int = 0) -> torch.Tensor:
    return apply_rotary(x, rotary, offset) if rotary is not None else x


class FiLMDecoderLayer(nn.Module):
    """self-attn -> FiLM, cross-attn (audio) -> FiLM, [cross-attn 2 (keyframes)
    -> FiLM], feed-forward -> FiLM; all pre-norm with residuals, in ``dtype``."""

    def __init__(self, dim: int, heads: int, ff_size: int, use_cm: bool = False,
                 flash: bool = False, dropout: float = 0.0, hash_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_cm, self.dtype = use_cm, dtype
        self.self_attn = MultiHeadAttention(dim, heads, flash, dropout, dtype)
        self.multihead_attn = MultiHeadAttention(dim, heads, flash, dropout, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.film1 = DenseFiLM(dim, dtype)
        self.film2 = DenseFiLM(dim, dtype)
        self.film3 = DenseFiLM(dim, dtype)
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)
        self.ff_drop = Dropout(dropout, hash_dropout)  # after the GELU
        self.drop = Dropout(dropout, hash_dropout)  # on each sublayer output
        if use_cm:
            # the keyframe memory is ~20 tokens: never built with the kernel
            self.multihead_attn2 = MultiHeadAttention(dim, heads, dropout=dropout, dtype=dtype)
            self.norm2a = nn.LayerNorm(dim, eps=1e-5)
            self.film2a = DenseFiLM(dim, dtype)

    def _norm(self, norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(norm, x, self.dtype)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        """linear1 -> erf GELU (as the reference) in the compute dtype."""
        return F.gelu(linear(self.linear1, self._norm(self.norm3, x), self.dtype))

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        t: torch.Tensor,  # [B, D] FiLM conditioning vector
        cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # projected audio-memory K, V
        # [B, Tm, D]: the denoiser projects all layers' cross K/V over the shared memory at once
        memory2: Optional[torch.Tensor] = None,  # [B, Tk, D] keyframe tokens (use_cm layers)
        rotary: Optional[RotaryTable] = None,
        generator: Optional[torch.Generator] = None,  # dropout draws (training)
        *,
        memory: Optional[torch.Tensor] = None,  # [B, Tm, D] raw audio memory, when no cross_kv (guide)
        self_bias: Optional[torch.Tensor] = None,  # additive self-attention bias (the guide's causal mask)
        x_offset: int = 0,  # rotary position of x's first row
    ) -> torch.Tensor:
        g = generator
        mt = F.mish(t)  # the FiLM blocks' shared input
        h = self._norm(self.norm1, x)
        qk = _maybe_rotate(h, rotary, x_offset)
        h = self.drop(self.self_attn(qk, qk, h, self_bias, generator=g), g)
        x = x + featurewise_affine(h, self.film1.from_mish(mt))

        h = self._norm(self.norm2, x)
        q = _maybe_rotate(h, rotary, x_offset)
        if cross_kv is None:  # K rotated, V not (JAX blocks.py:310-311)
            cross_kv = self.precompute_cross(memory, rotary)
        h = self.drop(self.multihead_attn.attend(q, *cross_kv, generator=g), g)
        x = x + featurewise_affine(h, self.film2.from_mish(mt))

        if self.use_cm:
            h = self._norm(self.norm2a, x)
            q = _maybe_rotate(h, rotary, x_offset)
            h = self.drop(self.multihead_attn2(q, _maybe_rotate(memory2, rotary), memory2, generator=g), g)
            x = x + featurewise_affine(h, self.film2a.from_mish(mt))

        h = self.ff_drop(self._ff(x), g)
        h = self.drop(linear(self.linear2, h, self.dtype), g)
        return x + featurewise_affine(h, self.film3.from_mish(mt))

    def precompute_cross(self, memory: torch.Tensor, rotary: Optional[RotaryTable]):
        """-> (cross_k, cross_v) [B, Tm, D]: constant across decode steps."""
        return self.multihead_attn.project_kv(_maybe_rotate(memory, rotary), memory)


class FeedForward(nn.Module):
    """Linear -> activation -> dropout -> Linear, as the reference's
    ``ff`` Sequential (indices 0 and 3 hold the weights), in ``dtype``.  The
    activation is erf GELU unless given (the lip regressor's is ReLU)."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.1, activation: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ff = nn.Sequential(nn.Linear(dim, hidden), activation or nn.GELU(), Dropout(dropout),
                                nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lin1, act, drop, lin2 = self.ff
        return linear(lin2, drop(act(linear(lin1, x, self.dtype)), generator), self.dtype)


class RotaryEncoderLayer(nn.Module):
    """Pre-norm self-attention with rotary Q/K (the full d_model rotated
    before the projections) and a GELU feed-forward, each sublayer output
    dropped before its residual add (reference: TransformerEncoderLayerRotary,
    transformer_modules.py:36-103).  The face denoiser's cond-encoder, in
    ``dtype``."""

    def __init__(self, dim: int, heads: int, ff_size: int, dropout: float = 0.1, flash: bool = False,
                 hash_dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(dim, heads, flash, dropout, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ff_size)
        self.linear2 = nn.Linear(ff_size, dim)
        self.ff_drop = Dropout(dropout, hash_dropout)  # after the GELU
        self.drop = Dropout(dropout, hash_dropout)  # on each sublayer output

    def forward(self, x: torch.Tensor, rotary: Optional[RotaryTable] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g, dt = generator, self.dtype
        h = layer_norm(self.norm1, x, dt)
        qk = _maybe_rotate(h, rotary)
        x = x + self.drop(self.self_attn(qk, qk, h, generator=g), g)
        h = self.ff_drop(F.gelu(linear(self.linear1, layer_norm(self.norm2, x, dt), dt)), g)
        return x + self.drop(linear(self.linear2, h, dt), g)
