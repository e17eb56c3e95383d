"""Weight-norm UNets.

Counterpart of ``audio2photoreal_tpu/render/unet.py`` (reference:
visualize/ca_body/nn/unet.py): ``UNetWB`` (:16-97), 5 stride-2 downs, 5
stride-2 transpose ups with ADDITIVE skips, the input concatenated at the
end, and a 1×1 out conv scaled by 0.1, all with untied biases;
``UNetWBConcat`` (:98-181), the same with CONCATENATED skips; ``UNetW``
(:182-254), tied biases, each up a bilinear doubling and a 3×3 conv.  Names:
``down{i}.0``, ``up{i}.0``, ``out``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render.layers import Conv2dWN, Conv2dWNUB, ConvTranspose2dWNUB, resize_bilinear

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


class UNetWBConcat(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int, n_init_ftrs: int = 8):
        super().__init__()
        F, S = n_init_ftrs, size
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        down = [(in_channels, F), (F, 2 * F), (2 * F, 4 * F), (4 * F, 8 * F), (8 * F, 16 * F)]
        for i, (ci, co) in enumerate(down, 1):
            s = S // 2**i
            setattr(self, f"down{i}", nn.Sequential(Conv2dWNUB(ci, co, s, s, 4, 2, 1), act()))
        # each up after the first takes [h, the skip] along channels
        up = [(16 * F, 8 * F), (16 * F, 4 * F), (8 * F, 2 * F), (4 * F, F), (2 * F, F)]
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
        h = self.up1(self.down5(x5))
        h = self.up2(torch.cat([h, x5], dim=1))
        h = self.up3(torch.cat([h, x4], dim=1))
        h = self.up4(torch.cat([h, x3], dim=1))
        h = self.up5(torch.cat([h, x2], dim=1))
        return self.out(torch.cat([h, x1], dim=1)) * OUT_SCALE


class UNetW(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, size: int, n_init_ftrs: int = 8):
        super().__init__()
        F = n_init_ftrs
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        widths = [in_channels, F, 2 * F, 4 * F, 8 * F, 16 * F]
        for i in range(1, 6):
            setattr(self, f"down{i}", nn.Sequential(Conv2dWN(widths[i - 1], widths[i], 4, 2, 1), act()))
        up = [(16 * F, 8 * F), (8 * F, 4 * F), (4 * F, 2 * F), (2 * F, F), (F, F)]
        for i, (ci, co) in enumerate(up, 1):
            setattr(self, f"up{i}", nn.Sequential(Conv2dWN(ci, co, 3, 1, 1), act()))
        self.out = Conv2dWN(F + in_channels, out_channels, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = [x]
        h = x
        for i in range(1, 6):
            h = getattr(self, f"down{i}")(h)
            acts.append(h)
        for i in range(1, 6):
            h = getattr(self, f"up{i}")(resize_bilinear(h, (h.shape[-2] * 2, h.shape[-1] * 2)))
            if i < 5:
                h = h + acts[5 - i]
        return self.out(torch.cat([h, x], dim=1)) * OUT_SCALE
