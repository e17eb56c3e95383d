"""Color pipeline: linear capture space ↔ display sRGB, and image helpers.

Counterpart of ``audio2photoreal_tpu/render/color.py`` (reference:
visualize/ca_body/utils/image.py): the inference color path (``linear2srgb``
:23-46, ``linear2display_batch`` :93-132) and the helpers
(``linear2color_corr`` :48-91 and its inverse :109-126, ``srgb2linear``
:288-309, ``mapped2linear`` / ``mapped2srgb`` :134-286, ``scale_diff_image``
:311-318, ``dilate`` / ``erode`` :379-409, ``smoothstep`` / ``smootherstep``
:411-419).  Images are channels-last unless ``dim`` says otherwise, as in
the JAX package; ``dilate`` / ``erode`` take [B, H, W] or [B, H, W, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear2srgb(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    """IEC 61966-2-1 linear → sRGB transfer (image.py:23-46)."""
    linear_part = img * 12.92
    exp_part = 1.055 * torch.pow(img.clamp_min(1e-12), 1.0 / gamma) - 0.055
    return torch.where(img <= 0.0031308, linear_part, exp_part)


def _channel_shape(ndim: int, dim: int) -> list:
    shape = [1] * ndim
    shape[dim if dim >= 0 else ndim + dim] = 3
    return shape


def linear2color_corr(img: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-channel gain, gamma and black level that the capture stage bakes
    in (image.py:48-91)."""
    g = (torch.tensor([1.2, 1.0, 1.5]) * torch.tensor([1.4, 1.1, 1.6])).to(img.device)
    black, gamma = 3.0 / 255.0, 2.0
    g = g.reshape(_channel_shape(img.dim(), dim))
    return ((((img * g) ** (1.0 / gamma)) - black) / (1.0 - black)).clamp(0.0, 1.0)


def linear2color_corr_inv(img: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of ``linear2color_corr`` (image.py:109-126)."""
    black, gamma = 3.0 / 255.0, 2.0
    scale = torch.tensor([1.4, 1.1, 1.6], device=img.device).reshape(_channel_shape(img.dim(), dim))
    img = torch.pow(img + 15.0 / 255.0, gamma) / (0.95 / (1 - black)) + black
    return (img / (scale / 1.1)).clamp(0.0, 1.0)


def srgb2linear(img: torch.Tensor, gamma: float = 2.4) -> torch.Tensor:
    """Inverse sRGB transfer (image.py:288-309)."""
    linear_part = img / 12.92
    exp_part = torch.pow((img.clamp_min(0.04045) + 0.055) / 1.055, gamma)
    return torch.where(img <= 0.04045, linear_part, exp_part)


def mapped2linear(img: torch.Tensor, dim: int = -1, ccm=((1, 0, 0), (0, 1, 0), (0, 0, 1)),
                  dc_offset=(0, 0, 0), gamma: float = 1.0) -> torch.Tensor:
    """Characterised camera color space → linear RGB (image.py:134-240):
    black level off, gamma decoded, the 3×3 color-correction matrix applied;
    saturated input pixels clamp to 1.  Floats in [0, 1] or integers in
    [0, 255]; returns f32 in [0, 1]."""
    eps = 1e-7
    if img.is_floating_point():
        saturated = img > (1.0 - eps)
        imgf = img.to(torch.float32)
    else:
        saturated = img == 255
        imgf = img.to(torch.float32) / 255.0
    dc = torch.tensor(dc_offset, dtype=torch.float32, device=img.device).reshape(_channel_shape(img.dim(), dim))
    img_linear = torch.pow((imgf - dc).clamp_min(eps), 1.0 / gamma)
    ccm_m = torch.tensor(ccm, dtype=torch.float32, device=img.device)
    corr = torch.tensordot(ccm_m, img_linear.movedim(dim, 0), dims=([1], [0])).movedim(0, dim)
    return torch.where(saturated, torch.ones_like(corr), corr.clamp(0.0, 1.0))


def mapped2srgb(img: torch.Tensor, dim: int = -1, ccm=((1, 0, 0), (0, 1, 0), (0, 0, 1)),
                dc_offset=(0, 0, 0), gamma: float = 1.0) -> torch.Tensor:
    """Camera space → sRGB (image.py:242-286)."""
    return linear2srgb(mapped2linear(img, dim, ccm, dc_offset, gamma))


def scale_diff_image(diff_img: torch.Tensor) -> torch.Tensor:
    """A difference image from [-max, max] to [0, 1], or to [0, 255] when
    its largest magnitude exceeds 1 (image.py:311-318)."""
    mval = diff_img.abs().max()
    half, top = (128.0, 255.0) if mval > 1 else (0.5, 1.0)
    return (half * (diff_img / mval) + half).clamp(0.0, top)


def dilate(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Binary dilation by a ks×ks box (image.py:379-394), [B, H, W] or
    [B, H, W, 1] of any dtype."""
    assert ks % 2 == 1
    xf = (x if x.dim() == 3 else x[..., 0]).to(torch.float32)[:, None]
    w = torch.ones((1, 1, ks, ks), dtype=torch.float32, device=x.device)
    out = F.conv2d(xf, w, padding=ks // 2)[:, 0] > 0
    return (out if x.dim() == 3 else out[..., None]).to(x.dtype)


def erode(x: torch.Tensor, ks: int) -> torch.Tensor:
    """Binary erosion: the dilation of the complement (image.py:397-408)."""
    if x.dtype == torch.bool:
        return ~dilate(~x, ks)
    return (1 - dilate(1 - x, ks)).to(x.dtype)


def smoothstep(e0, e1, x):
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def smootherstep(e0, e1, x):
    t = ((x - e0) / (e1 - e0)).clamp(0.0, 1.0)
    return (t**3) * (t * (t * 6 - 15) + 10)


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
