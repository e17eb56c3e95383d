"""The frozen wav2vec conv frontends, in plain PyTorch (a frozen copy of
the measured package's):

- ``Wav2VecFeatureExtractor``, the denoisers' vq-wav2vec frontend: per
  channel, 48 kHz -> 16 kHz resample, five valid convs without bias, each
  followed by a group norm over (C, T) jointly and a ReLU, then
  ``log(|x| + 1)``; the two channels concatenate to [B, Ta, 1024].
- ``Wav2VecEncoder``, the lip regressor's wav2vec_large: the same extractor
  on mono audio left-padded by 320 zeros at 16 kHz, then the 12-layer
  residual conv aggregator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import WAV2VEC_SR
from portbench.reference import dtypes
from portbench.reference.resample import resample

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
    """fairseq's Fp32GroupNorm(1, dim): moments over (C, T) jointly, the
    population variance, eps 1e-5; with a [B, T] ``mask`` the moments are
    taken over the frames it keeps and every frame is normalised.  The
    moments and the affine are f32 whatever x's dtype."""

    def __init__(self, dim: int):
        super().__init__(1, dim, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            return F.group_norm(x.float(), 1, self.weight, self.bias, self.eps).to(x.dtype)
        x32 = x.float()
        m = mask.float()[:, None, :]  # [B, 1, T]
        cnt = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * x.shape[1], min=1.0)
        mean = (x32 * m).sum(dim=(1, 2), keepdim=True) / cnt
        var = ((x32 - mean).square() * m).sum(dim=(1, 2), keepdim=True) / cnt
        out = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None] + self.bias[:, None]
        return out.to(x.dtype)


class ConvFeatureExtractor(nn.Module):
    """fairseq ConvFeatureExtractionModel: [B, S] -> [B, T, 512].

    ``compute_dtype="bfloat16"`` runs the convs on bf16 operands with f32
    sums and bf16 activations between the layers, the group-norm moments in
    f32, as the JAX package's frozen frontend does for training
    (audio_encoder.py:113-160); the features leave in f32."""

    def __init__(self, spec: Tuple[Tuple[int, int, int], ...] = VQ_WAV2VEC_SPEC,
                 log_compression: bool = True, compute_dtype: str = "float32"):
        super().__init__()
        self.log_compression = log_compression
        self.dtype = dtypes.compute_dtype(compute_dtype)
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

    def forward(self, wav: torch.Tensor, n_valid=None) -> torch.Tensor:
        """``n_valid`` (an int or a [B] tensor: the samples before zero
        padding) gives every group norm masked moments over the frames whose
        receptive field lies in the real signal."""
        dt = self.dtype
        x = wav[:, None, :]
        n = None if n_valid is None else torch.as_tensor(n_valid, device=wav.device).reshape(-1, 1)
        rf, jump = 1, 1
        for layer in self.conv_layers:
            conv, norm = layer[0], layer[2]
            x = F.conv1d(x.to(dt), conv.weight.to(dt), None, conv.stride)
            rf += (conv.kernel_size[0] - 1) * jump
            jump *= conv.stride[0]
            mask = None
            if n is not None:
                frames = torch.arange(x.shape[-1], device=wav.device)
                mask = (frames[None] < (n - rf) // jump + 1).float().expand(x.shape[0], -1)
            x = torch.relu(norm(x, mask))
        x = x.transpose(1, 2).float()
        if self.log_compression:
            x = torch.log(torch.abs(x) + 1.0)
        return x


class Wav2VecFeatureExtractor(nn.Module):
    """[B, S, 2] raw 48 kHz stereo -> [B, Ta, 1024] (reference:
    model/diffusion.py:285-293): each channel resampled to 16 kHz and run
    through the frozen extractor (in ``compute_dtype``), the channels
    concatenated."""

    def __init__(self, input_sr: int = 48_000, compute_dtype: str = "float32"):
        super().__init__()
        self.input_sr = input_sr
        self.feature_extractor = ConvFeatureExtractor(compute_dtype=compute_dtype)

    def forward(self, audio: torch.Tensor, n_valid=None) -> torch.Tensor:
        """``n_valid`` (48 kHz samples before zero padding, an int or [B])
        gives masked group-norm moments (``ConvFeatureExtractor``)."""
        n16 = None if n_valid is None else torch.as_tensor(n_valid) * WAV2VEC_SR // self.input_sr
        feats = [
            self.feature_extractor(resample(audio[..., ch], self.input_sr, WAV2VEC_SR), n_valid=n16)
            for ch in range(2)
        ]
        return torch.cat(feats, dim=-1)


class ConvAggregator(nn.Module):
    """fairseq ConvAggegator of wav2vec_large: [B, T, 512] -> [B, T, 512].
    Each layer is Sequential(left replication pad k-1, Conv1d with bias,
    Dropout (identity at inference), group norm, ReLU); with equal widths
    the layer's output is (y + x) * sqrt(residual_scale)."""

    def __init__(self, layers: Tuple[Tuple[int, int, int], ...] = tuple((512, k, 1) for k in range(2, 14)),
                 residual_scale: float = 0.5, in_dim: int = 512):
        super().__init__()
        self.rscale = residual_scale ** 0.5
        blocks = []
        cin = in_dim
        for dim, k, s in layers:
            blocks.append(nn.Sequential(
                nn.ReplicationPad1d((k - 1, 0)), nn.Conv1d(cin, dim, k, stride=s), nn.Identity(),
                GroupNormAll(dim), nn.ReLU(),
            ))
            cin = dim
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for layer in self.conv_layers:
            y = layer(x)
            x = (y + x) * self.rscale if y.shape[1] == x.shape[1] else y
        return x.transpose(1, 2)


class _Wav2VecModel(nn.Module):
    """The holder of fairseq's ``wav2vec_model`` names."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor()
        self.feature_aggregator = ConvAggregator()


class Wav2VecEncoder(nn.Module):
    """wav2vec_large extractor + aggregator: mono 48 kHz frames [B, T, 1600]
    -> [B, T_w2v, 512] at wav2vec's native ~100 Hz (no resize back to the
    frame grid: the lip regressor cross-attends to all of it)."""

    def __init__(self):
        super().__init__()
        self.wav2vec_model = _Wav2VecModel()

    def forward(self, audio_frames: torch.Tensor) -> torch.Tensor:
        wav = resample(audio_frames.reshape(audio_frames.shape[0], -1), 48_000, WAV2VEC_SR)
        wav = F.pad(wav, (320, 0))  # the reference's left zero pad (audio_encoder.py:39-42)
        m = self.wav2vec_model
        return m.feature_aggregator(m.feature_extractor(wav))
