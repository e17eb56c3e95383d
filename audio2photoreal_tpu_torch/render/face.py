"""Frontal face decoder (frozen conditioning translator).

Counterpart of ``audio2photoreal_tpu/render/face.py:FaceDecoderFrontal``
(reference: visualize/ca_body/nn/face.py:18-85): HQLP face codes → (face
geometry, face texture) by a linear geometry head and a deconv texture
pyramid conditioned on a fixed frontal view.  Names: ``encmod.0``,
``geommod.0``, ``viewmod.0``, ``texmod2.0``, ``texmod.{0,2,...}``, ``bias``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.render.layers import ConvTranspose2dWNUB, LinearWN

_TEX_PYRAMID = [256, 128, 128, 64, 64, 32, 8, 3]  # channel plan at tex_size=1024


class FaceDecoderFrontal(nn.Module):
    def __init__(self, frontal_view, n_latent: int = 256, n_vert_out: int = 3 * 7306,
                 tex_size: int = 1024):
        super().__init__()
        self.register_buffer("frontal_view", torch.as_tensor(frontal_view, dtype=torch.float32).reshape(3),
                             persistent=False)
        act = lambda: nn.LeakyReLU(0.2)  # noqa: E731
        self.encmod = nn.Sequential(LinearWN(n_latent, 256), act())
        self.geommod = nn.Sequential(LinearWN(256, n_vert_out))
        self.viewmod = nn.Sequential(LinearWN(3, 8), act())
        self.texmod2 = nn.Sequential(LinearWN(256 + 8, 256 * 4 * 4), act())
        n_ups = int(math.log2(tex_size // 4))
        plan = _TEX_PYRAMID[-n_ups:][:-1] + [3]
        layers, cin = [], 256
        for i, c in enumerate(plan):
            size = 4 * 2 ** (i + 1)
            layers.append(ConvTranspose2dWNUB(cin, c, size, size, 4, 2, 1))
            if i < len(plan) - 1:
                layers.append(act())
            cin = c
        self.texmod = nn.Sequential(*layers)
        self.bias = nn.Parameter(torch.zeros(3, tex_size, tex_size))

    def forward(self, face_embs: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = face_embs.shape[0]
        enc = self.encmod(face_embs)
        geom = self.geommod(enc)
        viewout = self.viewmod(self.frontal_view[None].expand(B, 3))
        h = self.texmod2(torch.cat([enc, viewout], dim=-1)).reshape(B, 256, 4, 4)
        tex_raw = self.texmod(h)
        tex = tex_raw + self.bias[None]
        return {
            "face_geom": geom.reshape(B, -1, 3),
            "face_tex_raw": tex_raw,
            "face_tex": 255.0 * (tex + 0.5),
        }

