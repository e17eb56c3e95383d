"""UV conv blocks (NCHW).

Counterpart of ``audio2photoreal_tpu/render/blocks.py`` (reference:
visualize/ca_body/nn/blocks.py): ``ConvBlock`` (:232-277), ``ConvDownBlock``
(:323-371), ``UpConvBlockDeep`` (:372-420: bilinear up, align_corners=True,
then convs, with a 1×1 residual) and the avatar's ``UpscaleNet``
(mesh_vae_drivable.py:740-770).  Submodule names are the reference's
(``conv_resize``, ``conv1``, ``conv2``, ``conv_block``, ``out_block``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render.layers import (
    Conv2dWN,
    Conv2dWNUB,
    lrelu,
    pixel_shuffle,
    resize_bilinear,
)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int,
                 kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.conv_resize = Conv2dWN(in_channels, out_channels, kernel_size=1, padding=0)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size, kernel_size, 1, padding)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size, size, kernel_size, 1, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.conv_resize(x)
        return lrelu(self.conv2(lrelu(self.conv1(x)))) + skip


class ConvDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int, groups: int = 1):
        super().__init__()
        self.conv_resize = Conv2dWN(in_channels, out_channels, kernel_size=1, stride=2,
                                    padding=0, groups=groups)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size, 3, 1, 1, groups=groups)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size // 2, size // 2, 3, 2, 1, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.conv_resize(x)
        return lrelu(self.conv2(lrelu(self.conv1(x)))) + skip


class UpConvBlockDeep(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int, groups: int = 1):
        super().__init__()
        self.size = size
        self.conv_resize = Conv2dWN(in_channels, out_channels, kernel_size=1, padding=0, groups=groups)
        self.conv1 = Conv2dWNUB(in_channels, in_channels, size, size, 3, 1, 1, groups=groups)
        self.conv2 = Conv2dWNUB(in_channels, out_channels, size, size, 3, 1, 1, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_up = resize_bilinear(x, (self.size, self.size), align_corners=True)
        skip = self.conv_resize(x_up)
        return lrelu(self.conv2(lrelu(self.conv1(x_up)))) + skip


class UpscaleNet(nn.Module):
    """1024 → 2048 pixel-shuffle residual upscaler: one 3×3 conv + the 1×1
    out block (the avatar's own definition, what body_dec.ckpt holds)."""

    def __init__(self, in_channels: int, out_channels: int = 3, n_ftrs: int = 16, size: int = 1024):
        super().__init__()
        self.conv_block = nn.Sequential(
            Conv2dWNUB(in_channels, n_ftrs, size, size, 3, 1, 1), nn.LeakyReLU(0.2)
        )
        self.out_block = Conv2dWNUB(n_ftrs, out_channels * 4, size, size, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.out_block(self.conv_block(x)), 2)
