"""The frozen vq-wav2vec conv frontend of the denoisers.

Counterpart of ``audio2photoreal_tpu/models/audio_encoder.py``
(``feature_frames``, ``ConvFeatureExtractor``, ``Wav2VecFeatureExtractor``):
per channel, 48 kHz -> 16 kHz resample, then five valid convs without bias
(strides 5*4*2*2*2 = 160), each followed by a group norm over (C, T) jointly
and a ReLU, then ``log(|x| + 1)``; 20 s of audio gives 1998 frames, and the
two channels concatenate to [B, Ta, 1024].

The modules keep fairseq's state-dict names (``conv_layers.{i}.0.weight``
for the conv, ``conv_layers.{i}.2.{weight,bias}`` for its Fp32GroupNorm), so
a reference checkpoint loads as it is.  The convs run in torch's [B, C, T]
layout inside the module; the public functions take and return [B, T, C].
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from audio2photoreal_tpu_torch.core.config import WAV2VEC_SR
from audio2photoreal_tpu_torch.ops.resample import resample

# (dim, kernel, stride) — fairseq wav2vec/vq-wav2vec feature extractor spec
VQ_WAV2VEC_SPEC: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 8, 4),
    (512, 4, 2),
    (512, 4, 2),
    (512, 4, 2),
)


def feature_frames(n_samples: int, spec=VQ_WAV2VEC_SPEC) -> int:
    """Output length of the valid conv stack (e.g. 320000 -> 1998)."""
    t = n_samples
    for _, k, s in spec:
        t = (t - k) // s + 1
    return t


class GroupNormAll(nn.GroupNorm):
    """fairseq's Fp32GroupNorm(1, dim): one group, so the moments are over
    (C, T) jointly, with the population variance and eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__(1, dim, eps=1e-5)


class ConvFeatureExtractor(nn.Module):
    """fairseq ConvFeatureExtractionModel: [B, S] -> [B, T, 512]."""

    def __init__(self, spec: Tuple[Tuple[int, int, int], ...] = VQ_WAV2VEC_SPEC,
                 log_compression: bool = True):
        super().__init__()
        self.log_compression = log_compression
        layers = []
        cin = 1
        for dim, k, s in spec:
            # index 1 is fairseq's Dropout (identity at inference), index 3 the ReLU
            layers.append(nn.Sequential(
                nn.Conv1d(cin, dim, k, stride=s, bias=False), nn.Identity(),
                GroupNormAll(dim), nn.ReLU(),
            ))
            cin = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        x = x.transpose(1, 2).float()
        if self.log_compression:
            x = torch.log(torch.abs(x) + 1.0)
        return x


class Wav2VecFeatureExtractor(nn.Module):
    """[B, S, 2] raw 48 kHz stereo -> [B, Ta, 1024] (reference:
    model/diffusion.py:285-293): each channel resampled to 16 kHz and run
    through the frozen extractor, the channels concatenated."""

    def __init__(self, input_sr: int = 48_000):
        super().__init__()
        self.input_sr = input_sr
        self.feature_extractor = ConvFeatureExtractor()

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        feats = [
            self.feature_extractor(resample(audio[..., ch], self.input_sr, WAV2VEC_SR))
            for ch in range(2)
        ]
        return torch.cat(feats, dim=-1)
