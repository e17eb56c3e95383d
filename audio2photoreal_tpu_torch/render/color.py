"""The inference color path: linear capture space → display sRGB.

Counterpart of ``linear2srgb`` and ``linear2display_batch`` in
``audio2photoreal_tpu/render/color.py`` (reference:
visualize/ca_body/utils/image.py:23-46, 93-132).
"""

from __future__ import annotations

import torch


def linear2srgb(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    """IEC 61966-2-1 linear → sRGB transfer (image.py:23-46)."""
    linear_part = img * 12.92
    exp_part = 1.055 * torch.pow(img.clamp_min(1e-12), 1.0 / gamma) - 0.055
    return torch.where(img <= 0.0031308, linear_part, exp_part)


def linear2display_batch(
    img: torch.Tensor,  # linear, 0..255 scale, any layout
    black: float = 5.0 / 255.0,
    white: float = 0.7,
) -> torch.Tensor:
    """The renderer's display transform (image.py:93-132): normalise by the
    black and white points, then sRGB; uint8-ready [0, 255] floats."""
    scaled = (img / 255.0 - black) / (white - black)
    srgb = linear2srgb(scaled.clamp(0.0, 1.0))
    return (srgb * 255.0).clamp(0.0, 255.0)
