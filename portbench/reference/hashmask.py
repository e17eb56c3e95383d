"""The dropout masks of the hash source, and attention with them, in plain
PyTorch.

The trainer's dropout is a position hash (the JAX package's ``"hash"``
mask source): attention probability (b, h, i, j) is kept iff
``hash(seed, (b*H + h)*nj + i // bq, i % bq, j) >= uint32(rate * 2**32)``
with ``bq = resolve_block_q(Tq, Tk)`` and ``nj = ceil(Tq / bq)``, and a
kept probability is scaled by ``float32(1) / float32(1 - rate)``.  The
activations' masks hash (seed, 0, flat index, 0).  The arithmetic is
uint32 held in int64.  ``attention`` is the einsum attention with that
mask multiplied into the probabilities, what the attention kernels must
compute.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference.attention import dot_product_attention

_U32 = 0xFFFFFFFF
_C_SEED, _C_BLOCK, _C_ROW, _C_COL, _C_MIX2 = 2654435761, 40503, 3266489917, 668265263, 668265263
_C_SEED_INV = pow(_C_SEED, -1, 2**32)


def u32_mul(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def u32_mix(h: torch.Tensor) -> torch.Tensor:
    h = u32_mul(h ^ (h >> 13), _C_SEED)
    h = u32_mul(h ^ (h >> 17), _C_MIX2)
    return h ^ (h >> 16)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def hash_bits(seed: int, block_id, rows, cols) -> torch.Tensor:
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64) & _U32  # noqa: E731
    h = ((seed & _U32) * _C_SEED) & _U32
    h = h + u32_mul(as_t(block_id), _C_BLOCK) + u32_mul(as_t(rows), _C_ROW) + u32_mul(as_t(cols), _C_COL)
    return u32_mix(h & _U32)


def shard_seed(seed: int, block_offset: int = 0, row_offset: int = 0) -> int:
    """The seed whose hash at (block, row) is ``seed``'s at (block +
    ``block_offset``, row + ``row_offset``)."""
    return (seed + (block_offset * _C_BLOCK + row_offset * _C_ROW) * _C_SEED_INV) & _U32


def resolve_block_q(Tq: int, Tk: int, block_q: Optional[int] = None) -> int:
    if block_q is None:
        tq16 = -(-Tq // 16) * 16
        tkp = max(128, -(-Tk // 128) * 128)
        bq_max = max(128, (10 * 1024 * 1024 // (14 * tkp)) // 16 * 16)
        n_blocks = -(-tq16 // min(tq16, bq_max))
        block_q = -(-(-(-Tq // n_blocks)) // 16) * 16
    return min(block_q, max(8, -(-Tq // 8) * 8))


def dropout_mask(B: int, H: int, Tq: int, Tk: int, rate: float, seed: int, device=None) -> torch.Tensor:
    """[B, H, Tq, Tk] float32 multiplier of the attention dropout."""
    bq = resolve_block_q(Tq, Tk)
    nj = -(-Tq // bq)
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    i = torch.arange(Tq, device=device).reshape(1, 1, Tq, 1)
    j = torch.arange(Tk, device=device).reshape(1, 1, 1, Tk)
    keep = hash_bits(seed, bh * nj + i // bq, i % bq, j) >= int(rate * 2**32)
    return keep.to(torch.float32) * keep_scale(rate)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0,
              seed: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) o M v for [B, H, T, Dh] operands, logits
    and softmax in f32, the probabilities rounded to q's dtype before the
    product (where the bf16 kernels round them)."""
    if dropout_rate == 0.0:
        return dot_product_attention(q, k, v)
    B, H, Tq, _ = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))
    mask = dropout_mask(B, H, Tq, k.shape[2], dropout_rate, seed, q.device)
    return torch.matmul((torch.softmax(logits, dim=-1) * mask).to(q.dtype), v)
