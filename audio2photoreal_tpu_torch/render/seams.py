"""UV-seam fixups.

Counterpart of ``audio2photoreal_tpu/render/seams.py:SeamSampler`` (reference:
visualize/ca_body/utils/seams.py): ``impaint`` (:16-21) copies source texels
over destination texels; ``resample`` (:23-52) blends grid-sampled values
across the seam by per-texel weights.  ``apply(tex, n)`` runs impaint then n
resamples in sequence — what the JAX package's ``fused_apply`` composes into
one tap table, a TPU gather layout that is not ported.

``apply_display`` is the display-space variant of ``fused_apply_packed``
(seams.py:281-316): the texture has been rounded to 8 bits in display space;
the seam rows blend those values and are rounded and clipped again.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class SeamSampler(nn.Module):
    """Seam tables as non-persistent buffers (flat texel indices into H·W)."""

    def __init__(self, impaint_dst, impaint_src, resample_uvs, resample_dst, resample_weights,
                 uv_size: int):
        super().__init__()
        self.uv_size = uv_size
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
        self.register_buffer("impaint_dst", t(impaint_dst, torch.long), persistent=False)
        self.register_buffer("impaint_src", t(impaint_src, torch.long), persistent=False)
        # [M, 2] normalized sample coords in [-1, 1], (x, y)
        self.register_buffer("resample_uvs", t(resample_uvs, torch.float32).reshape(-1, 2), persistent=False)
        self.register_buffer("resample_dst", t(resample_dst, torch.long), persistent=False)
        self.register_buffer("resample_weights", t(resample_weights, torch.float32), persistent=False)

    @property
    def is_empty(self) -> bool:
        return self.impaint_dst.numel() == 0 and self.resample_dst.numel() == 0

    def impaint(self, tex: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W]: copy src → dst texels (seams.py:16-21)."""
        if self.impaint_dst.numel() == 0:
            return tex
        B, C, H, W = tex.shape
        flat = tex.reshape(B, C, H * W)
        out = flat.clone()
        out[:, :, self.impaint_dst] = flat[:, :, self.impaint_src]
        return out.reshape(B, C, H, W)

    def resample(self, tex: torch.Tensor) -> torch.Tensor:
        """Blend re-sampled seam texels into the texture (seams.py:23-52):
        bilinear, align_corners=False, border padding."""
        if self.resample_dst.numel() == 0:
            return tex
        B, C, H, W = tex.shape
        grid = self.resample_uvs[None, :, None, :].expand(B, -1, 1, 2).to(tex.dtype)
        sampled = F.grid_sample(tex, grid, mode="bilinear", padding_mode="border",
                                align_corners=False)[..., 0]  # [B, C, M]
        flat = tex.reshape(B, C, H * W)
        w = self.resample_weights.to(tex.dtype)
        blended = flat[:, :, self.resample_dst] * (1.0 - w) + sampled * w
        out = flat.clone()
        out[:, :, self.resample_dst] = blended
        return out.reshape(B, C, H, W)

    def apply(self, tex: torch.Tensor, n_resample: int = 2) -> torch.Tensor:
        """impaint, then ``n_resample`` resample passes.  A bf16 texture runs
        the passes in f32 and is rounded once at the end, as the JAX
        package's composed taps sum in f32 (seams.py:264-276)."""
        if tex.dtype in (torch.bfloat16, torch.float16) and not self.is_empty:
            return self.apply(tex.float(), n_resample).to(tex.dtype)
        tex = self.impaint(tex)
        for _ in range(n_resample):
            tex = self.resample(tex)
        return tex

    def apply_display(self, tex_q: torch.Tensor, n_resample: int = 2) -> torch.Tensor:
        """The seam passes on a display-space texture already rounded to 8
        bits (float values in 0..255): the same passes, then the result is
        rounded and clipped to 0..255 again.  Texels off the seam tables
        keep their values exactly."""
        if self.is_empty:
            return tex_q
        return torch.round(self.apply(tex_q, n_resample)).clamp(0.0, 255.0)
