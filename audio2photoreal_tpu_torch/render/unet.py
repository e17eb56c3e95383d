"""UNet with weight-norm + untied-bias convs and additive skips.

Counterpart of ``audio2photoreal_tpu/render/unet.py:UNetWB`` (reference:
visualize/ca_body/nn/unet.py:16-97): 5 stride-2 downs, 5 stride-2
transpose ups with ADDITIVE skips, the input concatenated at the end, and a
1×1 out conv scaled by 0.1.  Names: ``down{i}.0``, ``up{i}.0``,
``out``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render.layers import Conv2dWNUB, ConvTranspose2dWNUB

OUT_SCALE = 0.1


class UNetWB(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int, n_init_ftrs: int = 8):
        super().__init__()
        F, S = n_init_ftrs, size
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        down = [(in_channels, F), (F, 2 * F), (2 * F, 4 * F), (4 * F, 8 * F), (8 * F, 16 * F)]
        for i, (ci, co) in enumerate(down, 1):
            s = S // 2**i
            setattr(self, f"down{i}", nn.Sequential(Conv2dWNUB(ci, co, s, s, 4, 2, 1), act()))
        up = [(16 * F, 8 * F), (8 * F, 4 * F), (4 * F, 2 * F), (2 * F, F), (F, F)]
        for i, (ci, co) in enumerate(up, 1):
            s = S // 2 ** (5 - i)
            setattr(self, f"up{i}", nn.Sequential(ConvTranspose2dWNUB(ci, co, s, s, 4, 2, 1), act()))
        self.out = Conv2dWNUB(F + in_channels, out_channels, S, S, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = x
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x6 = self.down5(x5)
        h = self.up1(x6) + x5
        h = self.up2(h) + x4
        h = self.up3(h) + x3
        h = self.up4(h) + x2
        h = self.up5(h)
        return self.out(torch.cat([h, x1], dim=1)) * OUT_SCALE
