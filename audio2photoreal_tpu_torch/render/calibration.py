"""Per-camera calibration modules of the avatar's training forward.

Counterpart of ``audio2photoreal_tpu/render/calibration.py`` (reference:
visualize/ca_body/nn/color_cal.py, dof_cal.py and mesh_vae_drivable.py's
pixel_cal):
- ``CalV3``: per-camera per-channel affine;
- ``CalV5``: Gaussian blur, then the per-camera affine; the identity
  camera's rows are pinned by zeroing their gradient (the reference's grad
  hook, color_cal.py:26-35), so AdamW never moves them;
- ``LearnableBlur``: per-camera softmax mix of identity, 3x3 and 7x7
  Gaussian blurs, and its regulariser toward the identity;
- ``CameraPixelBias``: a per-camera bias at 1/8 of the image, stored
  [n_cameras, 1, H/8, W/8] as the reference stores it, bilinearly upsampled.

Images are NCHW; cameras are integer ids ``cam_idx`` [B].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.render.layers import resize_bilinear


def gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian blur of [B, C, H, W] with zero (SAME)
    padding: the column pass, then the row pass."""
    C = img.shape[1]
    k = torch.as_tensor(gaussian_kernel1d(size, sigma), dtype=img.dtype, device=img.device)
    img = F.conv2d(img, k.view(1, 1, size, 1).expand(C, 1, size, 1), padding=(size // 2, 0), groups=C)
    return F.conv2d(img, k.view(1, 1, 1, size).expand(C, 1, 1, size), padding=(0, size // 2), groups=C)


def _per_camera(table: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
    """[n_cameras, C] rows of ``cam_idx`` → [B, C, 1, 1]."""
    return table[cam_idx][:, :, None, None]


class CalV3(nn.Module):
    """Per-camera per-channel affine: y = w[cam] x + b[cam]."""

    def __init__(self, n_cameras: int, identity_camera: int = 0):
        super().__init__()
        self.identity_camera = identity_camera
        self.weight = nn.Parameter(torch.ones(n_cameras, 3))
        self.bias = nn.Parameter(torch.zeros(n_cameras, 3))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def affine(self, img: torch.Tensor, cam_idx: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        return img * _per_camera(weight, cam_idx) + _per_camera(bias, cam_idx)

    def forward(self, img: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
        return self.affine(img, cam_idx, self.weight, self.bias)


class CalV5(CalV3):
    """Blur-then-affine (color_cal.py:100-321): the blur models the sensors'
    MTF differences, the affine each camera's color response."""

    def __init__(self, n_cameras: int, identity_camera: int = 0, blur_size: int = 5, blur_sigma: float = 1.0):
        super().__init__(n_cameras, identity_camera)
        self.blur_size, self.blur_sigma = blur_size, blur_sigma

    def _pin_identity(self, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        grad[self.identity_camera] = 0.0
        return grad

    def _pinned(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` as a view whose gradient has the identity camera's row zeroed."""
        p = p.view_as(p)
        if p.requires_grad:
            p.register_hook(self._pin_identity)
        return p

    def forward(self, img: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
        blurred = gaussian_blur(img, self.blur_size, self.blur_sigma)
        return self.affine(blurred, cam_idx, self._pinned(self.weight), self._pinned(self.bias))


class LearnableBlur(nn.Module):
    """Per-camera depth-of-field proxy (dof_cal.py:16-52)."""

    def __init__(self, n_cameras: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(n_cameras, 3))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weights.zero_()

    def mix(self, cam_idx: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.weights[cam_idx], dim=-1)  # [B, 3]

    def forward(self, img: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
        m = self.mix(cam_idx)[:, :, None, None, None]  # [B, 3, 1, 1, 1]
        stack = torch.stack([img, gaussian_blur(img, 3, 1.0), gaussian_blur(img, 7, 2.0)], dim=1)
        return (stack * m).sum(dim=1)

    def reg(self, cam_idx: torch.Tensor) -> torch.Tensor:
        """The mean weight off the identity kernel (dof_cal's reg)."""
        return (1.0 - self.mix(cam_idx)[:, 0]).mean()


class CameraPixelBias(nn.Module):
    """Per-camera low-resolution bias, upsampled onto the render and
    broadcast over its channels (mesh_vae_drivable.py:52-70)."""

    def __init__(self, n_cameras: int, height: int, width: int, ds_rate: int = 8):
        super().__init__()
        self.height, self.width = height, width
        self.bias = nn.Parameter(torch.zeros(n_cameras, 1, height // ds_rate, width // ds_rate))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, cam_idx: torch.Tensor) -> torch.Tensor:
        """→ [B, 1, H, W]."""
        return resize_bilinear(self.bias[cam_idx], (self.height, self.width))
