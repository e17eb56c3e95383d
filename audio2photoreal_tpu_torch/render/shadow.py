"""Shadow networks.

Counterpart of ``audio2photoreal_tpu/render/shadow.py`` (reference:
visualize/ca_body/nn/shadow.py): ``ShadowUNet`` (:25-192) — AO map minus
mean → 4-level interp-down/up UNet → sigmoid(pred + β), names
``enc_layers.{i}.0``, ``dec_layers.{i}.0``, ``shadow_pred``; and
``PoseToShadow`` (:418-462) — pose → shadow map by a deconv pyramid, names
``fc_block.0`` and ``conv_block.{0,2,4,6,8}``.  The variants no ported
avatar builds, under the same layers and naming: ``ShadowUNetPoseCond``
(:249-417, the pose injected at the bottleneck by ``pose_fc.0``),
``FloorShadowDecoder`` (:192-248, ``down_layers.{i}.0`` / ``up_layers.{i}.0``)
and ``DistMapShadowUNet`` (:463-615, the trunk on K distance channels).
"""

from __future__ import annotations

from typing import Dict, Optional

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


def _act() -> nn.Module:
    return nn.LeakyReLU(0.2)


class _UNetTrunk(nn.Module):
    """The shadow UNets' 4-level trunk: ``enc_layers.{i}.0`` at S / 2^i with
    align-corners bilinear halving between them, ``dec_layers.{i}.0`` back
    up, each after the first on [upsampled, skip] (shadow.py:25-192)."""

    def __init__(self, in_channels: int, shadow_size: int, n_dims: int):
        super().__init__()
        S, n = shadow_size, n_dims
        sizes = [S // 2**i for i in range(4)]
        self.enc_layers = nn.ModuleList(
            nn.Sequential(Conv2dWNUB(in_channels if i == 0 else n, n, s, s, 3, 1, 1), _act())
            for i, s in enumerate(sizes)
        )
        self.dec_layers = nn.ModuleList(
            nn.Sequential(Conv2dWNUB(n if i == 0 else 2 * n, n, s, s, 3, 1, 1), _act())
            for i, s in enumerate(reversed(sizes))
        )

    def trunk(self, x: torch.Tensor, bottleneck: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``bottleneck``, when given, is added to the coarsest features."""
        enc_acts = []
        for i, layer in enumerate(self.enc_layers):
            x = layer(x)
            enc_acts.append(x)
            if i < len(self.enc_layers) - 1:
                x = resize_bilinear(x, (x.shape[-2] // 2, x.shape[-1] // 2), align_corners=True)
        if bottleneck is not None:
            x = x + bottleneck
        for i, layer in enumerate(self.dec_layers):
            if i > 0:
                x_prev = enc_acts[-i - 1]
                x = resize_bilinear(x, tuple(x_prev.shape[-2:]), align_corners=True)
                x = torch.cat([x, x_prev], dim=1)
            x = layer(x)
        return x


class ShadowUNet(_UNetTrunk):
    def __init__(self, uv_size: int, shadow_size: int, ao_mean: torch.Tensor,
                 n_dims: int = 64, biases: bool = True):
        """``ao_mean`` [1, H, W] is a static asset (a non-persistent buffer)."""
        super().__init__(1, shadow_size, n_dims)
        self.uv_size, self.shadow_size = uv_size, shadow_size
        self.register_buffer("ao_mean", torch.as_tensor(ao_mean, dtype=torch.float32), persistent=False)
        S, n = shadow_size, n_dims
        self.shadow_pred = (
            Conv2dWNUB(n, 1, S, S, 3, 1, 1) if biases else Conv2dWN(n, 1, 3, 1, 1)
        )

    def centered_ao(self, ao_map: torch.Tensor) -> torch.Tensor:
        """(ao_map at S×S, ao_map − ao_mean at S×S)."""
        S = self.shadow_size
        ao_map = resize_bilinear(ao_map, (S, S))
        return ao_map, ao_map - resize_bilinear(self.ao_mean[None], (S, S))

    def forward(self, ao_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        ao_map, x = self.centered_ao(ao_map)
        lowres = torch.sigmoid(self.shadow_pred(self.trunk(x)) + BETA)
        shadow_map = resize_bilinear(lowres, (self.uv_size, self.uv_size))
        return {"shadow_map": shadow_map, "ao_map": ao_map, "shadow_map_lowres": lowres}


class ShadowUNetPoseCond(ShadowUNet):
    """``ShadowUNet`` with the pose added at the bottleneck through
    ``pose_fc.0`` (shadow.py:249-417); a tied-bias ``shadow_pred``."""

    def __init__(self, uv_size: int, shadow_size: int, ao_mean: torch.Tensor, n_pose_dims: int = 104,
                 n_dims: int = 64):
        super().__init__(uv_size, shadow_size, ao_mean, n_dims, biases=False)
        self.pose_fc = nn.Sequential(LinearWN(n_pose_dims, n_dims), _act())

    def forward(self, ao_map: torch.Tensor, pose: torch.Tensor) -> Dict[str, torch.Tensor]:
        _, x = self.centered_ao(ao_map)
        lowres = torch.sigmoid(self.shadow_pred(self.trunk(x, self.pose_fc(pose)[:, :, None, None])) + BETA)
        return {"shadow_map": resize_bilinear(lowres, (self.uv_size, self.uv_size))}


class FloorShadowDecoder(nn.Module):
    """Ground-plane shadow from a top-down occupancy / AO map
    (shadow.py:192-248): three stride-2 convs down, three bilinear doublings
    each followed by a conv, tied biases throughout."""

    def __init__(self, uv_size: int, in_channels: int = 1, n_dims: int = 32):
        super().__init__()
        self.uv_size = uv_size
        n = n_dims
        self.down_layers = nn.ModuleList(
            nn.Sequential(Conv2dWN(ci, co, 3, 2, 1), _act())
            for ci, co in ((in_channels, n), (n, 2 * n), (2 * n, 4 * n))
        )
        self.up_layers = nn.ModuleList(
            nn.Sequential(Conv2dWN(ci, co, 3, 1, 1), _act()) for ci, co in ((4 * n, 2 * n), (2 * n, n), (n, n))
        )
        self.shadow_pred = Conv2dWN(n, 1, 3, 1, 1)

    def forward(self, height_map: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = height_map
        for layer in self.down_layers:
            x = layer(x)
        for layer in self.up_layers:
            x = layer(resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2)))
        lowres = torch.sigmoid(self.shadow_pred(x) + BETA)
        return {"shadow_map": resize_bilinear(lowres, (self.uv_size, self.uv_size))}


class DistMapShadowUNet(_UNetTrunk):
    """Shadow from K body-part distance maps (shadow.py:463-615): the
    ``ShadowUNet`` trunk on ``n_channels`` inputs, a tied-bias
    ``shadow_pred``."""

    def __init__(self, uv_size: int, shadow_size: int, n_channels: int = 8, n_dims: int = 64):
        super().__init__(n_channels, shadow_size, n_dims)
        self.uv_size, self.shadow_size = uv_size, shadow_size
        self.shadow_pred = Conv2dWN(n_dims, 1, 3, 1, 1)

    def forward(self, dist_maps: torch.Tensor) -> Dict[str, torch.Tensor]:
        S = self.shadow_size
        x = self.trunk(resize_bilinear(dist_maps, (S, S)))
        lowres = torch.sigmoid(self.shadow_pred(x) + BETA)
        return {"shadow_map": resize_bilinear(lowres, (self.uv_size, self.uv_size))}


class PoseToShadow(nn.Module):
    def __init__(self, n_pose_dims: int, uv_size: int):
        super().__init__()
        self.uv_size = uv_size
        act = _act
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
