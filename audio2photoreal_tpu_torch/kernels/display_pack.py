"""Display finalisation of the render's texture: the CUDA kernel
``csrc/display_pack.cu`` and its plain version.

Replaces ``audio2photoreal_tpu/ops/pallas/display_pack.py:
finalize_display_packed`` (the TPU kernel ``_finalize_kernel``): from the
raw texture (before x std + mean), the seam-resampled shadow and the
per-person texture mean, one pass computes ``tex_rec = (tex * std + mean) *
shadow`` and its display-space value ``round(linear2display_batch(tex_rec))``
clamped to 0..255, all in f32.  The tensors are in the port's planar layout:
tex [B, 3, H, W], shadow [B, 1, H, W], mean [3, H, W].

- ``finalize_display`` is the render's display pass (``render/mesh_vae.py:
  render_view``): the display values as f32 [B, 3, H, W] and ``tex_rec``.
- ``finalize_display_packed`` returns what the JAX function returns, RGB8
  packed in int32 [B, H, W] (R | G << 8 | B << 16).

A bf16 texture (the renderer's bf16 compute mode, ``render/layers.py:
render_compute_dtype``) computes ``tex_rec`` as the JAX package's bf16 render
does (mesh_vae.py:forward_tex): std and the mean rounded to bf16, the
shadow cast to bf16, a bf16 rounding after x std, after + mean and after x
shadow; the display value then comes from ``float(tex_rec)`` in f32
(mesh_vae.py:513).  It launches the kernel's bf16 instantiation, counted as
``display_pack_bf16``.

A CPU tensor takes the plain version (``finalize_display_reference``, the
composed chain the render ran before the kernel); a CUDA tensor launches the
kernel for its dtype or raises.  The kernel's design and what bounds it are
in the source's head note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from audio2photoreal_tpu_torch.kernels import launch_counts
from audio2photoreal_tpu_torch.kernels.build import load_library
from audio2photoreal_tpu_torch.render.color import linear2display_batch

NAME = "display_pack"
BF16_NAME = "display_pack_bf16"  # the bf16 instantiation: its C entry and its launch count
SOURCES = ("display_pack.cu",)
ENTRIES = {torch.float32: NAME, torch.bfloat16: BF16_NAME}  # the texture's dtype -> C entry
BLACK, WHITE = 5.0 / 255.0, 0.7  # the renderer's display points (color.linear2display_batch)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    lib = load_library(NAME, SOURCES)
    for entry in ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def carrier_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (the JAX package's ``jnp.asarray(x,
    dtype)``), as a Python float: a scalar that multiplies a tensor of that
    dtype exactly as a tensor of it would."""
    return float(torch.tensor(x, dtype=dtype))


def pack_rgb8(display: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] display values (integers 0..255 as floats) -> int32
    [B, H, W], R | G << 8 | B << 16."""
    q = display.to(torch.int32)
    return q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)


def finalize_display_reference(
    tex: torch.Tensor,
    shadow: torch.Tensor,
    mean: torch.Tensor,
    std: float,
    black: float = BLACK,
    white: float = WHITE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (display [B, 3, H, W] f32, tex_rec
    [B, 3, H, W] in tex's dtype) by the composed chain, in its order; std,
    the mean and the shadow in tex's dtype (each rounded once for bf16)."""
    dt = tex.dtype
    tex_rec = (tex * carrier_scalar(std, dt) + mean[None].to(dt)) * shadow.to(dt)
    display = torch.round(linear2display_batch(tex_rec.float(), black, white)).clamp(0.0, 255.0)
    return display, tex_rec


def _check(tex, shadow, mean) -> None:
    if tex.dim() != 4 or tex.shape[1] != 3:
        raise ValueError(f"tex must be [B, 3, H, W]; got {tuple(tex.shape)}")
    B, _, H, W = tex.shape
    if tuple(shadow.shape) != (B, 1, H, W):
        raise ValueError(f"shadow must be [{B}, 1, {H}, {W}]; got {tuple(shadow.shape)}")
    if tuple(mean.shape) != (3, H, W):
        raise ValueError(f"mean must be [3, {H}, {W}]; got {tuple(mean.shape)}")
    devices = {t.device for t in (tex, shadow, mean)}
    if len(devices) != 1:
        raise ValueError(f"tex, shadow, mean on different devices: {devices}")
    if tex.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no display kernel for device {tex.device}")
    if tex.device.type == "cuda" and (tex.dtype not in ENTRIES or shadow.dtype != tex.dtype
                                      or mean.dtype != torch.float32):
        raise ValueError(f"the display kernel takes a float32 or bfloat16 texture and shadow and a float32 "
                         f"mean; got {tex.dtype}, {shadow.dtype}, {mean.dtype}")


def _launch(tex, shadow, mean, std, black, white, packed: bool, with_tex_rec: bool):
    B, _, H, W = tex.shape
    entry = ENTRIES[tex.dtype]
    tex, shadow, mean = tex.contiguous(), shadow.contiguous(), mean.contiguous()
    if packed:
        out, tex_rec = torch.empty((B, H, W), dtype=torch.int32, device=tex.device), None
    else:
        out = torch.empty(tex.shape, dtype=torch.float32, device=tex.device)
        tex_rec = torch.empty_like(tex) if with_tex_rec else None
    # the plain version's f32 constants: black and 1 / (white - black) as
    # PyTorch rounds a Python scalar and its reciprocal
    inv_range = float(np.float32(1.0) / np.float32(white - black))
    fn = getattr(library(), entry)
    with torch.cuda.device(tex.device):
        err = fn(tex.data_ptr(), shadow.data_ptr(), mean.data_ptr(), out.data_ptr(),
                 tex_rec.data_ptr() if tex_rec is not None else None, B, H * W, carrier_scalar(std, tex.dtype),
                 float(np.float32(black)), inv_range, int(packed),
                 torch.cuda.current_stream(tex.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    launch_counts[entry] += 1
    return out, tex_rec


def finalize_display(
    tex: torch.Tensor,  # [B, 3, H, W] raw texture (before x std + mean)
    shadow: torch.Tensor,  # [B, 1, H, W] seam-resampled shadow
    mean: torch.Tensor,  # [3, H, W] per-person texture mean
    std: float,
    black: float = BLACK,
    white: float = WHITE,
    with_tex_rec: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(display values 0..255 as f32 [B, 3, H, W], tex_rec or None).  The
    shadow is cast to tex's dtype.  CPU tensors take the plain version; CUDA
    float32 or bfloat16 tensors launch the kernel for their dtype on the
    current stream; anything else raises."""
    shadow = shadow.to(tex.dtype)
    _check(tex, shadow, mean)
    if tex.device.type == "cpu":
        display, tex_rec = finalize_display_reference(tex, shadow, mean, std, black, white)
        return display, (tex_rec if with_tex_rec else None)
    return _launch(tex, shadow, mean, std, black, white, packed=False, with_tex_rec=with_tex_rec)


def finalize_display_packed(
    tex: torch.Tensor,
    shadow: torch.Tensor,
    mean: torch.Tensor,
    std: float,
    black: float = BLACK,
    white: float = WHITE,
) -> torch.Tensor:
    """The JAX function's result, RGB8 packed in int32 [B, H, W], from the
    port's planar tensors.  CPU tensors take the plain version; CUDA float32
    or bfloat16 tensors launch the kernel; anything else raises."""
    shadow = shadow.to(tex.dtype)
    _check(tex, shadow, mean)
    if tex.device.type == "cpu":
        return pack_rgb8(finalize_display_reference(tex, shadow, mean, std, black, white)[0])
    return _launch(tex, shadow, mean, std, black, white, packed=True, with_tex_rec=False)[0]
