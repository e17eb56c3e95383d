"""Screen-space triangle rasterization and texture lookup.

Counterpart of ``audio2photoreal_tpu/render/rasterizer.py`` (reference:
visualize/ca_body/utils/render.py:28-63, pytorch3d's MeshRasterizer +
TexturesUV): OpenCV camera, pixel centres at integer coordinates, two-sided
faces, nearest depth wins.  ``rasterize`` is the CUDA kernel on a CUDA
tensor and its plain version ``rasterize_reference`` on a CPU tensor
(``kernels/raster.py``).

Textures are NCHW [B, C, Ht, Wt] with rows ∝ v; images come out [B, H, W, C].
The display path (``render_mesh(display=True)``) samples a display-space
texture that has been rounded to 8 bits, with border padding — the JAX
package's packed-RGB8 sampler (ops/gridsample.py) without its int32 packing
and quad gathers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from audio2photoreal_tpu_torch.kernels.raster import RasterOut, rasterize, rasterize_reference

__all__ = [
    "RasterOut", "rasterize", "rasterize_reference", "interpolate_uv", "render_texture", "render_mesh",
]


def interpolate_uv(
    raster: RasterOut,
    uv_coords: torch.Tensor,  # [Vt, 2]
    uv_faces: torch.Tensor,  # [F, 3]
) -> torch.Tensor:
    """Per-pixel UV from the barycentrics (TexturesUV sampling prep,
    render.py:50-57) → [B, H, W, 2], rows ∝ v."""
    face_uv = uv_coords[uv_faces]  # [F, 3, 2]
    tuv = face_uv[raster.face_index.clamp_min(0).long()]  # [B, H, W, 3, 2]
    return (tuv * raster.barys[..., None]).sum(dim=-2)


def render_texture(
    raster: RasterOut,
    uv_pix: torch.Tensor,  # [B, H, W, 2] uv in [0, 1]
    texture: torch.Tensor,  # [B, C, Ht, Wt]
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Bilinear texture lookup (align_corners=False) masked by coverage →
    [B, H, W, C].  The linear path pads with zeros; the display path with
    the border, as the JAX package's two samplers do.  A bf16 texture is
    sampled in f32 at the f32 coordinates (the JAX sampler's promotion)."""
    grid = uv_pix * 2.0 - 1.0
    texture = texture.to(torch.promote_types(texture.dtype, grid.dtype))
    img = F.grid_sample(texture, grid.to(texture.dtype), mode="bilinear", padding_mode=padding_mode,
                        align_corners=False).permute(0, 2, 3, 1)
    mask = (raster.face_index >= 0)[..., None]
    return torch.where(mask, img, torch.zeros_like(img))


def render_mesh(
    pix_verts: torch.Tensor,  # [B, V, 2]
    depth: torch.Tensor,  # [B, V]
    faces: torch.Tensor,  # [F, 3]
    uv_coords: torch.Tensor,  # [Vt, 2]
    uv_faces: torch.Tensor,  # [F, 3]
    texture: torch.Tensor,  # [B, C, Ht, Wt]
    height: int,
    width: int,
    display: bool = False,
) -> Tuple[torch.Tensor, RasterOut]:
    """RenderLayer equivalent (render.py:28-63) → (image [B, H, W, C],
    raster).  The raster interpolates UV itself (per-corner UVs ride with the
    faces).  ``display=True`` takes ``texture`` as display-space values
    already rounded to 8 bits and samples them with border padding; the
    image is then display [0, 255], uint8-ready."""
    raster = rasterize(pix_verts, depth, faces, height, width, face_uv=uv_coords[uv_faces])
    img = render_texture(raster, raster.uv, texture, "border" if display else "zeros")
    return img, raster
