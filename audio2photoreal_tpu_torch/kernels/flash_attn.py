"""Attention forward and backward: the CUDA kernels, their plain versions,
and the autograd pair.  f32 tensors take ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` (3xTF32 on ``mma.sync``), bf16 tensors
``csrc/flash_attn_fwd_bf16.cu`` (warp-specialised ``wgmma`` with TMA: a
producer warpgroup, two consumers taking turns on the tensor cores, a
persistent grid) and ``csrc/flash_attn_bwd_bf16.cu`` (warp-specialised
``wgmma`` with TMA: a key-stationary dK/dV kernel and a query-stationary dQ
kernel).

Replaces ``audio2photoreal_tpu/ops/pallas/flash.py`` (``flash_attention``
with its custom VJP -> ``_flash_fwd`` / ``_attn_kernel`` and ``_flash_bwd`` /
``_attn_bwd_kernel``) with the same semantics: [B, H, Tq, Dh] x [B, H, Tk, Dh]
-> [B, H, Tq, Dh], a [B, Tk] key-validity mask as a -1e9 additive bias, an
optional causal mask aligned at ``j <= i + (Tk - Tq)``, f32 logits and
softmax statistics, output in the input dtype.  In bf16 the products take
bf16 operands with f32 sums, rounding where the TPU kernel rounds
(flash.py:149, :178-201): the probabilities (after dropout) before P V, and
in the backward P o M before dV and dS before dQ and dK; the plain versions
round at the same places.

Attention-prob dropout replays the JAX package's ``"hash"`` mask source
(``hash_mask_mult``): element (b, h, i, j) keeps iff
``hash(seed, (b*H + h)*nj + i // bq, i % bq, j) >= uint32(rate * 2**32)``,
with ``bq = resolve_block_q(Tq, Tk)`` (or the caller's ``block_q``) and
``nj = ceil(Tq / bq)``, and a kept probability is scaled by
``float32(1) / float32(1 - rate)``.  ``block_q`` fixes only that numbering:
the kernels' own tiles do not follow it.  The TPU's ``"prng"`` source has
no counterpart here.

The kernels take q, k and v as strided [B, H, T, Dh] views whose Dh axis is
contiguous and whose rows start on 16 bytes (the model's head split of a [B,
T, H*Dh] projection is one), so no layout copy precedes a launch; the
forward writes its output into [B, Tq, H, Dh] storage and returns that
storage's [B, H, Tq, Dh] view, whose ``transpose(1, 2)`` is the model's [B,
Tq, H*Dh] without a copy.

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
BF16_NAME = "flash_attn_fwd_bf16"
BF16_SOURCES = ("flash_attn_fwd_bf16.cu",)
BF16_BWD_NAME = "flash_attn_bwd_bf16"
BF16_BWD_SOURCES = ("flash_attn_bwd_bf16.cu",)
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_U32 = 0xFFFFFFFF
# the mix's multipliers (flash.py:100-107)
_C_SEED, _C_BLOCK, _C_ROW, _C_COL, _C_MIX2 = 2654435761, 40503, 3266489917, 668265263, 668265263
_C_SEED_INV = pow(_C_SEED, -1, 2**32)
_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int]


def _bind_fwd(name: str, sources) -> ctypes.CDLL:
    lib = load_library(name, sources)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + _DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    split = getattr(lib, f"{name}_split")
    split.argtypes = [ctypes.c_int] * 5
    split.restype = ctypes.c_int
    return lib


def _bind_bwd(name: str, sources) -> ctypes.CDLL:
    lib = load_library(name, sources)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + _DROPOUT_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = getattr(lib, f"{name}_scratch_floats")
    scratch.argtypes = [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and bind the f32 forward kernel's library."""
    return _bind_fwd(NAME, SOURCES)


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """Build (at first use) and bind the f32 backward kernels' library."""
    return _bind_bwd(BWD_NAME, BWD_SOURCES)


@functools.lru_cache(maxsize=None)
def bf16_library() -> ctypes.CDLL:
    """Build (at first use) and bind the bf16 forward kernel's library."""
    return _bind_fwd(BF16_NAME, BF16_SOURCES)


@functools.lru_cache(maxsize=None)
def bf16_bwd_library() -> ctypes.CDLL:
    """Build (at first use) and bind the bf16 backward kernels' library."""
    return _bind_bwd(BF16_BWD_NAME, BF16_BWD_SOURCES)


def _fwd_kernel(dtype: torch.dtype):
    """(launch-count name, library) of the forward kernel for ``dtype``; the
    library's entry point is named after the kernel."""
    if dtype == torch.bfloat16:
        return BF16_NAME, bf16_library()
    return NAME, library()


def _bwd_kernel(dtype: torch.dtype):
    """(launch-count name, library) of the backward kernels for ``dtype``;
    the library's entry point is named after the kernel."""
    if dtype == torch.bfloat16:
        return BF16_BWD_NAME, bf16_bwd_library()
    return BWD_NAME, bwd_library()


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


def shard_seed(seed: int, block_offset: int = 0, row_offset: int = 0) -> int:
    """The seed whose ``hash_bits`` at (block, row) are ``seed``'s at (block +
    ``block_offset``, row + ``row_offset``): the mix is linear in the three
    terms before its first shift, and the seed's multiplier is odd, so
    seed' = seed + (block_offset·C_block + row_offset·C_row)·C_seed⁻¹ mod
    2³².  A rank holding rows r·B/N.. of a batch replays the global batch's
    mask under it, with no change to the kernels."""
    return (seed + (block_offset * _C_BLOCK + row_offset * _C_ROW) * _C_SEED_INV) & _U32


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
    """The plain PyTorch version of the backward from the kernels' formulas:
    with P the softmax and M the dropout multiplier, dV = (P o M)^T dO,
    dP = dO V^T o M, D = rowsum(P o dP), dS = P o (dP - D), dQ = scale dS K,
    dK = scale dS^T Q.  Sums in f32; for bf16 inputs P o M and dS are
    rounded to bf16 before their products, as the TPU kernel rounds them
    (flash.py:190, :201), and the gradients once at the end."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    carrier = lambda x: x.to(q.dtype).float()  # noqa: E731  (identity for f32)
    p = _probs(q, k, kv_valid, causal)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    pm = p
    if dropout_rate > 0.0:
        B, H, Tq, _ = q.shape
        mask = dropout_mask(B, H, Tq, k.shape[2], dropout_rate, seed, block_q, q.device)
        pm, dp = p * mask, dp * mask
    dv = torch.matmul(carrier(pm).transpose(-1, -2), gf)
    ds = carrier(p * (dp - (p * dp).sum(-1, keepdim=True)))
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
        if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"q, k, v must share one dtype of {list(DTYPES)}; "
                             f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if Dh not in HEAD_DIMS:
            raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_rows(name, t)
    return q.device


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels read a [B, H, T, Dh] operand row by row with 16-byte
    copies: its Dh axis must be contiguous and every row start on 16 bytes."""
    step = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
        raise ValueError(f"{name} must be a [B, H, T, Dh] view with a contiguous Dh axis and rows on "
                         f"16 bytes; got strides {t.stride()}")


def _strides(*ts: torch.Tensor):
    """The batch, head and time strides of each [B, H, T, Dh] operand, in
    elements, as the C entry points read them."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _valid_f32(kv_valid):
    return None if kv_valid is None else kv_valid.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fwd_split(B: int, H: int, Tq: int, Tk: int, Dh: int, dtype=torch.float32) -> int:
    """The number of cluster blocks that share one q tile's keys in the
    forward kernel for ``dtype`` at this shape (1 = no split), as a launch
    with ``split=0`` chooses it on the current card."""
    name, lib = _fwd_kernel(dtype)
    s = getattr(lib, f"{name}_split")(B, H, Tq, Tk, Dh)
    if s < 1:
        raise RuntimeError(f"{name}: no split for this shape: cudaError_t {-s}")
    return s


def bwd_scratch_floats(B: int, H: int, Tq: int, Tk: int, Dh: int, dtype=torch.float32) -> int:
    """Floats of f32 scratch the backward kernels for ``dtype`` take at this
    shape: the f32 kernels' dQ partials, one [B, H, Tq, Dh] plane per key
    block; the bf16 kernels' three [B, H, Tq rounded up to the q tile] row
    planes."""
    name, lib = _bwd_kernel(dtype)
    n = getattr(lib, f"{name}_scratch_floats")(B, H, Tq, Tk, Dh)
    if n < 0:
        raise ValueError(f"{name}: no scratch size for this shape")
    return n


def _launch_fwd(q, k, v, kv_valid, causal, dropout_rate, seed, block_q, with_lse, split=0):
    """Launch the forward kernel for q's dtype; ``split`` forces the number
    of cluster blocks per q tile (1-4; 0 lets the kernel choose)."""
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    drop = _dropout_args(dropout_rate, seed, Tq, Tk, block_q)
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if with_lse else None
    valid = _valid_f32(kv_valid)  # held until the launch is enqueued
    name, lib = _fwd_kernel(q.dtype)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), out.data_ptr(),
                 _ptr(lse), _strides(q, k, v, out), B, H, Tq, Tk, Dh,
                 int(causal), split, *drop, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError_t, or 10000 + the "
                           "CUresult of a refused tensor map)")
    launch_counts[name] += 1
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
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    _check_rows("out", out)
    _check_rows("dout", dout)
    drop = _dropout_args(dropout_rate, seed, Tq, Tk, block_q)
    name, lib = _bwd_kernel(q.dtype)
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=device) for x in (q, k, v))
    # f32: the rows' D and the dQ partial of every key block, summed in a fixed
    # order by the last kernel; bf16: the rows' planes (lse, D, dropout row
    # terms) that the dK/dV kernel reads by TMA, D among them
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=device) if q.dtype == torch.float32 else None
    scratch = torch.empty(bwd_scratch_floats(B, H, Tq, Tk, Dh, q.dtype), dtype=torch.float32, device=device)
    valid = _valid_f32(kv_valid)  # held until the launches are enqueued
    with torch.cuda.device(device):
        err = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(valid), out.data_ptr(),
                                 dout.data_ptr(), lse.data_ptr(), _ptr(delta), scratch.data_ptr(),
                                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 _strides(q, k, v, out, dout, dq, dk, dv), B, H, Tq, Tk, Dh,
                                 int(causal), *drop, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err} (a cudaError_t, or 10000 + the "
                           "CUresult of a refused tensor map)")
    launch_counts[name] += 1
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
    ``flash_attention_bwd_reference``).  CUDA tensors must be [B, H, T, Dh]
    views with a contiguous Dh axis and rows on 16 bytes, of one dtype
    (float32 or bfloat16) with Dh 64 or 128, on one device; they launch the
    kernel on the current stream and return the [B, H, Tq, Dh] view of [B,
    Tq, H, Dh] storage; anything else raises.  The log-sum-exp is written
    only when a gradient will be taken."""
    _check(q, k, v, kv_valid)
    _dropout_args(dropout_rate, seed, q.shape[2], k.shape[2], block_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_valid, causal, dropout_rate, seed, block_q)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_valid, causal, dropout_rate, seed, block_q)
    return _launch_fwd(q, k, v, kv_valid, causal, dropout_rate, seed, block_q, with_lse=False)[0]
