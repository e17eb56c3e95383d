"""Attention forward and backward: the CUDA kernels ``csrc/flash_attn_fwd.cu``
and ``csrc/flash_attn_bwd.cu``, their plain versions, and the autograd pair.

Replaces ``audio2photoreal_tpu/ops/pallas/flash.py`` (``flash_attention``
with its custom VJP -> ``_flash_fwd`` / ``_attn_kernel`` and ``_flash_bwd`` /
``_attn_bwd_kernel``) with the same semantics: [B, H, Tq, Dh] x [B, H, Tk, Dh]
-> [B, H, Tq, Dh], a [B, Tk] key-validity mask as a -1e9 additive bias, an
optional causal mask aligned at ``j <= i + (Tk - Tq)``, f32 logits and
softmax statistics, output in the input dtype.

Attention-prob dropout replays the JAX package's ``"hash"`` mask source
(``hash_mask_mult``): element (b, h, i, j) keeps iff
``hash(seed, (b*H + h)*nj + i // bq, i % bq, j) >= uint32(rate * 2**32)``,
with ``bq = resolve_block_q(Tq, Tk)`` (or the caller's ``block_q``) and
``nj = ceil(Tq / bq)``, and a kept probability is scaled by
``float32(1) / float32(1 - rate)``.  ``block_q`` fixes only that numbering:
the kernels tile at 64 rows whatever it is.  The TPU's ``"prng"`` source has
no counterpart here.

Each wrapper takes its plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises.  The kernels' designs, and what bounds them on
the card, are in the sources' head notes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from audio2photoreal_tpu_torch.kernels import launch_counts
from audio2photoreal_tpu_torch.kernels.build import load_library
from audio2photoreal_tpu_torch.ops.attention import causal_bias, dot_product_attention, padding_bias

NAME = "flash_attn_fwd"
SOURCES = ("flash_attn_fwd.cu",)
BWD_NAME = "flash_attn_bwd"
BWD_SOURCES = ("flash_attn_bwd.cu",)
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF
# the mix's multipliers (flash.py:100-107)
_C_SEED, _C_BLOCK, _C_ROW, _C_COL, _C_MIX2 = 2654435761, 40503, 3266489917, 668265263, 668265263
_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and bind the forward kernel's library."""
    lib = load_library(NAME, SOURCES)
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + _DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """Build (at first use) and bind the backward kernels' library."""
    lib = load_library(BWD_NAME, BWD_SOURCES)
    fn = lib.flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + _DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------- #
# the replayed dropout mask
# --------------------------------------------------------------------- #


def u32_mul(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32): ``c`` is split in
    16-bit halves so that no product leaves the int64 range (torch's uint32
    arithmetic is incomplete)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def u32_mix(h: torch.Tensor) -> torch.Tensor:
    """The xorshift-multiply finaliser of flash.py:106-108 on int64 holding
    uint32 values; ``>>`` of a non-negative int64 is the logical shift."""
    h = u32_mul(h ^ (h >> 13), _C_SEED)
    h = u32_mul(h ^ (h >> 17), _C_MIX2)
    return h ^ (h >> 16)


def _keep_scale(rate: float) -> float:
    """float32(1) / float32(1 - rate): the JAX package's ``keep / (1 - rate)``
    for a kept element, rounded as float32 division rounds it."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def hash_bits(seed: int, block_id, rows, cols) -> torch.Tensor:
    """The uint32 bits (in int64) of flash.py:97-108 for (seed, block, row
    within the q-block, key column).  ``block_id``, ``rows`` and ``cols`` are
    ints or int64 tensors that broadcast together; all are taken mod 2**32."""
    as_t = lambda x: torch.as_tensor(x, dtype=torch.int64) & _U32  # noqa: E731
    h = ((seed & _U32) * _C_SEED) & _U32
    h = h + u32_mul(as_t(block_id), _C_BLOCK) + u32_mul(as_t(rows), _C_ROW) + u32_mul(as_t(cols), _C_COL)
    return u32_mix(h & _U32)


def hash_mask_mult(seed: int, block_id, rows, cols, rate: float) -> torch.Tensor:
    """The JAX package's ``hash_mask_mult`` (flash.py:89): float32 multiplier,
    0 or 1/(1 - rate), keeping where the bits reach uint32(rate * 2**32)."""
    keep = hash_bits(seed, block_id, rows, cols) >= int(rate * 2**32)
    return keep.to(torch.float32) * _keep_scale(rate)


def resolve_block_q(Tq: int, Tk: int, block_q: Optional[int] = None) -> int:
    """The q-block size of the mask numbering: the JAX package's auto rule
    (``flash.py:_resolve``), the fewest blocks whose [bq, Tkp] temporaries
    fit ~10 MB, or ``block_q`` capped at Tq rounded up to 8."""
    if block_q is None:
        tq16 = -(-Tq // 16) * 16
        tkp = max(128, -(-Tk // 128) * 128)
        bq_max = max(128, (10 * 1024 * 1024 // (14 * tkp)) // 16 * 16)
        n_blocks = -(-tq16 // min(tq16, bq_max))
        block_q = -(-(-(-Tq // n_blocks)) // 16) * 16
    return min(block_q, max(8, -(-Tq // 8) * 8))


def dropout_mask(B: int, H: int, Tq: int, Tk: int, rate: float, seed: int,
                 block_q: Optional[int] = None, device=None) -> torch.Tensor:
    """[B, H, Tq, Tk] float32 multiplier of the kernels' replayed dropout."""
    bq = resolve_block_q(Tq, Tk, block_q)
    nj = -(-Tq // bq)
    bh = torch.arange(B * H, device=device).reshape(B, H, 1, 1)
    i = torch.arange(Tq, device=device).reshape(1, 1, Tq, 1)
    j = torch.arange(Tk, device=device).reshape(1, 1, 1, Tk)
    return hash_mask_mult(seed, bh * nj + i // bq, i % bq, j, rate)


def _dropout_args(rate: float, seed: int, Tq: int, Tk: int, block_q: Optional[int]):
    """(on, seed, threshold, mult, bq, nj) for the C entry points."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1); got {rate}")
    if rate == 0.0:
        return (0, 0, 0, 1.0, 1, Tq)
    bq = resolve_block_q(Tq, Tk, block_q)
    return (1, seed & _U32, int(rate * 2**32), _keep_scale(rate), bq, -(-Tq // bq))


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #


def _bias(q, k, kv_valid, causal):
    bias = None
    if kv_valid is not None:
        bias = padding_bias(kv_valid)
    if causal:
        cb = causal_bias(q.shape[2], k.shape[2], device=q.device)
        bias = cb if bias is None else bias + cb
    return bias


def _probs(q, k, kv_valid, causal) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / (q.shape[-1] ** 0.5))
    bias = _bias(q, k, kv_valid, causal)
    return torch.softmax(logits if bias is None else logits + bias, dim=-1)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    seed: int = 0,
    block_q: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the einsum attention with the same masks
    and, with ``dropout_rate > 0``, the explicit replayed dropout mask."""
    if dropout_rate == 0.0:
        return dot_product_attention(q, k, v, _bias(q, k, kv_valid, causal))
    B, H, Tq, _ = q.shape
    mask = dropout_mask(B, H, Tq, k.shape[2], dropout_rate, seed, block_q, q.device)
    return torch.matmul((_probs(q, k, kv_valid, causal) * mask).to(q.dtype), v)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    seed: int = 0,
    block_q: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward, in f32 from the kernels'
    formulas: with P the softmax and M the dropout multiplier,
    dV = (P o M)^T dO, dP = dO V^T o M, D = rowsum(P o dP),
    dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    p = _probs(q, k, kv_valid, causal)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    pm = p
    if dropout_rate > 0.0:
        B, H, Tq, _ = q.shape
        mask = dropout_mask(B, H, Tq, k.shape[2], dropout_rate, seed, block_q, q.device)
        pm, dp = p * mask, dp * mask
    dv = torch.matmul(pm.transpose(-1, -2), gf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------- #


def _check(q, k, v, kv_valid) -> torch.device:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, Dh]; got {q.shape}, {k.shape}, {v.shape}")
    B, H, _, Dh = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != Dh or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, {H}, Tk, {Dh}]; got {k.shape}, {v.shape}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("empty query or key sequence")
    if kv_valid is not None and tuple(kv_valid.shape) != (B, k.shape[2]):
        raise ValueError(f"kv_valid must be [{B}, {k.shape[2]}]; got {tuple(kv_valid.shape)}")
    devices = {t.device for t in (q, k, v)} | ({kv_valid.device} if kv_valid is not None else set())
    if len(devices) != 1:
        raise ValueError(f"q, k, v, kv_valid on different devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    if q.device.type == "cuda":
        if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one dtype of {list(_DTYPE_CODES)}; "
                             f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if Dh not in HEAD_DIMS:
            raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("q, k, v must be contiguous [B, H, T, Dh]")
    return q.device


def _valid_f32(kv_valid):
    return None if kv_valid is None else kv_valid.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, kv_valid, causal, dropout_rate, seed, block_q, with_lse):
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    drop = _dropout_args(dropout_rate, seed, Tq, Tk, block_q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if with_lse else None
    valid = _valid_f32(kv_valid)  # held until the launch is enqueued
    fn = library().flash_attn_fwd
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), out.data_ptr(),
                 _ptr(lse), B, H, Tq, Tk, Dh, _DTYPE_CODES[q.dtype], int(causal), *drop,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: Optional[torch.Tensor],
    lse: Optional[torch.Tensor],
    dout: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    seed: int = 0,
    block_q: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention``.  ``out`` and ``lse`` are the
    forward's output and [B, H, Tq] f32 log-sum-exp (the kernels read them;
    CPU tensors take ``flash_attention_bwd_reference``, which recomputes
    everything).  CUDA tensors launch the three backward kernels on the
    current stream; anything they do not take raises."""
    device = _check(q, k, v, kv_valid)
    if dout.shape != q.shape or dout.device != device:
        raise ValueError(f"dout must be {tuple(q.shape)} on {device}; got {tuple(dout.shape)} on {dout.device}")
    if device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, dout, kv_valid, causal, dropout_rate, seed, block_q)
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    if out is None or lse is None or out.shape != q.shape or tuple(lse.shape) != (B, H, Tq):
        raise ValueError("the backward kernels need the forward's out [B, H, Tq, Dh] and lse [B, H, Tq]")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"out and dout must be {q.dtype} and lse float32")
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("out, dout and lse must be contiguous")
    drop = _dropout_args(dropout_rate, seed, Tq, Tk, block_q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=device)
    valid = _valid_f32(kv_valid)  # held until the launches are enqueued
    fn = bwd_library().flash_attn_bwd
    with torch.cuda.device(device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, Tq, Tk, Dh, _DTYPE_CODES[q.dtype], int(causal), *drop,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_NAME} launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The custom VJP of flash.py:373-439: the forward keeps its output and
    log-sum-exp, the backward launches the backward kernels (plain versions
    for CPU tensors) with the same dropout arguments, so the mask replays."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, dropout_rate, seed, block_q):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, kv_valid, causal, dropout_rate, seed, block_q), None
        else:
            out, lse = _launch_fwd(q, k, v, kv_valid, causal, dropout_rate, seed, block_q, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.args = (causal, dropout_rate, seed, block_q)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(), kv_valid, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    seed: int = 0,
    block_q: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + masks) o M v, differentiable in q, k, v.

    CPU tensors take ``flash_attention_reference`` (and, under autograd,
    ``flash_attention_bwd_reference``).  CUDA tensors must be contiguous, of
    one dtype (float32 or bfloat16) with Dh 64 or 128, on one device; they
    launch the kernel on the current stream, and anything else raises.  The
    log-sum-exp is written only when a gradient will be taken."""
    _check(q, k, v, kv_valid)
    _dropout_args(dropout_rate, seed, q.shape[2], k.shape[2], block_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_valid, causal, dropout_rate, seed, block_q)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_valid, causal, dropout_rate, seed, block_q)
    return _launch_fwd(q, k, v, kv_valid, causal, dropout_rate, seed, block_q, with_lse=False)[0]
