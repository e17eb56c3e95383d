"""Shadow networks.

Counterpart of ``audio2photoreal_tpu/render/shadow.py`` (reference:
visualize/ca_body/nn/shadow.py): ``ShadowUNet`` (:25-192) — AO map minus
mean → 4-level interp-down/up UNet → sigmoid(pred + β), names
``enc_layers.{i}.0``, ``dec_layers.{i}.0``, ``shadow_pred``; and
``PoseToShadow`` (:418-462) — pose → shadow map by a deconv pyramid, names
``fc_block.0`` and ``conv_block.{0,2,4,6,8}``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render.layers import (
    Conv2dWN,
    Conv2dWNUB,
    ConvTranspose2dWNUB,
    LinearWN,
    resize_bilinear,
)

BETA = 1.0  # sigmoid(pred + β) (shadow.py:25-192, 418-462)


class ShadowUNet(nn.Module):
    def __init__(self, uv_size: int, shadow_size: int, ao_mean: torch.Tensor,
                 n_dims: int = 64, biases: bool = True):
        """``ao_mean`` [1, H, W] is a static asset (a non-persistent buffer)."""
        super().__init__()
        self.uv_size, self.shadow_size = uv_size, shadow_size
        self.register_buffer("ao_mean", torch.as_tensor(ao_mean, dtype=torch.float32), persistent=False)
        S, n = shadow_size, n_dims
        sizes = [S // 2**i for i in range(4)]
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        self.enc_layers = nn.ModuleList(
            nn.Sequential(Conv2dWNUB(1 if i == 0 else n, n, s, s, 3, 1, 1), act())
            for i, s in enumerate(sizes)
        )
        self.dec_layers = nn.ModuleList(
            nn.Sequential(Conv2dWNUB(n if i == 0 else 2 * n, n, s, s, 3, 1, 1), act())
            for i, s in enumerate(reversed(sizes))
        )
        self.shadow_pred = (
            Conv2dWNUB(n, 1, S, S, 3, 1, 1) if biases else Conv2dWN(n, 1, 3, 1, 1)
        )

    def forward(self, ao_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        S = self.shadow_size
        ao_map = resize_bilinear(ao_map, (S, S))
        ao_mean = resize_bilinear(self.ao_mean[None], (S, S))[0]
        x = ao_map - ao_mean[None]
        enc_acts = []
        for i, layer in enumerate(self.enc_layers):
            x = layer(x)
            enc_acts.append(x)
            if i < len(self.enc_layers) - 1:
                x = resize_bilinear(x, (x.shape[-2] // 2, x.shape[-1] // 2), align_corners=True)
        for i, layer in enumerate(self.dec_layers):
            if i > 0:
                x_prev = enc_acts[-i - 1]
                x = resize_bilinear(x, tuple(x_prev.shape[-2:]), align_corners=True)
                x = torch.cat([x, x_prev], dim=1)
            x = layer(x)
        lowres = torch.sigmoid(self.shadow_pred(x) + BETA)
        shadow_map = resize_bilinear(lowres, (self.uv_size, self.uv_size))
        return {"shadow_map": shadow_map, "ao_map": ao_map, "shadow_map_lowres": lowres}


class PoseToShadow(nn.Module):
    def __init__(self, n_pose_dims: int, uv_size: int):
        super().__init__()
        self.uv_size = uv_size
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        self.fc_block = nn.Sequential(LinearWN(n_pose_dims, 256 * 4 * 4), act())
        self.conv_block = nn.Sequential(
            ConvTranspose2dWNUB(256, 256, 8, 8, 4, 2, 1), act(),
            ConvTranspose2dWNUB(256, 128, 16, 16, 4, 2, 1), act(),
            ConvTranspose2dWNUB(128, 128, 32, 32, 4, 2, 1), act(),
            ConvTranspose2dWNUB(128, 64, 64, 64, 4, 2, 1), act(),
            ConvTranspose2dWNUB(64, 1, 128, 128, 4, 2, 1),
        )

    def forward(self, pose: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.fc_block(pose).reshape(pose.shape[0], 256, 4, 4)
        lowres = torch.sigmoid(self.conv_block(h) + BETA)
        return {"shadow_map": resize_bilinear(lowres, (self.uv_size, self.uv_size))}
