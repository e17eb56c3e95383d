"""Attention forward: the CUDA kernel ``csrc/flash_attn_fwd.cu`` and its plain version.

Replaces the forward of ``audio2photoreal_tpu/ops/pallas/flash.py``
(``flash_attention`` -> ``_flash_fwd`` -> ``_attn_kernel``) with the same
semantics: [B, H, Tq, Dh] x [B, H, Tk, Dh] -> [B, H, Tq, Dh], a [B, Tk]
key-validity mask as a -1e9 additive bias, an optional causal mask aligned
at ``j <= i + (Tk - Tq)``, f32 logits and softmax statistics, output in the
input dtype.  The kernel's design, and what bounds it on the card, are in
the source's head note.  Attention-prob dropout is training only and comes
with the backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from audio2photoreal_tpu_torch.kernels import launch_counts
from audio2photoreal_tpu_torch.kernels.build import load_library
from audio2photoreal_tpu_torch.ops.attention import causal_bias, dot_product_attention, padding_bias

NAME = "flash_attn_fwd"
SOURCES = ("flash_attn_fwd.cu",)
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    lib = load_library(NAME, SOURCES)
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version: the einsum attention with the same masks."""
    bias = None
    if kv_valid is not None:
        bias = padding_bias(kv_valid)
    if causal:
        cb = causal_bias(q.shape[2], k.shape[2], device=q.device)
        bias = cb if bias is None else bias + cb
    return dot_product_attention(q, k, v, bias)


def _check_shapes(q, k, v, kv_valid) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, Dh]; got {q.shape}, {k.shape}, {v.shape}")
    B, H, _, Dh = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != Dh or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, {H}, Tk, {Dh}]; got {k.shape}, {v.shape}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("empty query or key sequence")
    if kv_valid is not None and tuple(kv_valid.shape) != (B, k.shape[2]):
        raise ValueError(f"kv_valid must be [{B}, {k.shape[2]}]; got {tuple(kv_valid.shape)}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + masks) v.

    CPU tensors take ``flash_attention_reference``.  CUDA tensors must be
    contiguous, of one dtype (float32 or bfloat16) with Dh 64 or 128, on one
    device; they launch the kernel on the current stream, and anything else
    raises."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention-prob dropout comes with the backward kernel")
    _check_shapes(q, k, v, kv_valid)
    devices = {t.device for t in (q, k, v)} | ({kv_valid.device} if kv_valid is not None else set())
    if len(devices) != 1:
        raise ValueError(f"q, k, v, kv_valid on different devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_valid, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPE_CODES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Tq, Dh = q.shape
    Tk = k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous [B, H, T, Dh]")
    valid = None
    if kv_valid is not None:
        valid = kv_valid.to(torch.float32).contiguous()
    fn = library().flash_attn_fwd
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr() if valid is not None else None, out.data_ptr(),
            B, H, Tq, Tk, Dh, _DTYPE_CODES[q.dtype], int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return out
