"""The frozen wav2vec conv frontends.

Counterpart of ``audio2photoreal_tpu/models/audio_encoder.py``:

- ``Wav2VecFeatureExtractor``, the denoisers' vq-wav2vec frontend: per
  channel, 48 kHz -> 16 kHz resample, then five valid convs without bias
  (strides 5*4*2*2*2 = 160), each followed by a group norm over (C, T)
  jointly and a ReLU, then ``log(|x| + 1)``; 20 s of audio gives 1998
  frames, and the two channels concatenate to [B, Ta, 1024].
- ``Wav2VecEncoder``, the lip regressor's wav2vec_large (reference:
  audio_encoder.py:24-46): the same extractor on mono audio left-padded by
  320 zeros at 16 kHz, then ``ConvAggregator``, fairseq's 12-layer residual
  conv stack (kernels 2..13, replication left-pad, group norm, ReLU,
  residual x sqrt(0.5)), at wav2vec's ~100 Hz.

- ``Wav2VecDownsampler`` (reference: audio_encoder.py:48-74): 100 Hz
  wav2vec features to a frame rate, and ``AudioTcn`` (audio_encoder.py:
  78-194), the reference's alternative conditioning encoder: a log-mel
  branch and a frozen wav2vec_large branch into a causal dilated TCN.  No
  pipeline of either package calls them.

The wav2vec modules keep fairseq's state-dict names (extractor: ``conv_layers.{i}.0.weight`` for the conv,
``conv_layers.{i}.2.{weight,bias}`` for its Fp32GroupNorm; aggregator: the
conv at ``conv_layers.{i}.1``, the norm at ``conv_layers.{i}.3``), so a
reference checkpoint loads as it is.  The convs run in torch's [B, C, T]
layout inside the modules; the public functions take and return [B, T, C].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from audio2photoreal_tpu_torch.core.config import WAV2VEC_SR
from audio2photoreal_tpu_torch.core import dtypes
from audio2photoreal_tpu_torch.ops.convs import causal_conv1d
from audio2photoreal_tpu_torch.ops.melspec import melspectrogram
from audio2photoreal_tpu_torch.ops.resample import resample
from audio2photoreal_tpu_torch.parallel import collectives

# (dim, kernel, stride) — fairseq wav2vec/vq-wav2vec feature extractor spec
VQ_WAV2VEC_SPEC: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 8, 4),
    (512, 4, 2),
    (512, 4, 2),
    (512, 4, 2),
)


MOMENT_CHUNK = 1 << 16  # frames a step of the masked second moment's sum


def feature_frames(n_samples: int, spec=VQ_WAV2VEC_SPEC) -> int:
    """Output length of the valid conv stack (e.g. 320000 -> 1998)."""
    t = n_samples
    for _, k, s in spec:
        t = (t - k) // s + 1
    return t


class GroupNormAll(nn.GroupNorm):
    """fairseq's Fp32GroupNorm(1, dim): one group, so the moments are over
    (C, T) jointly, with the population variance and eps 1e-5.  With a
    [B, T] ``mask`` the moments are taken over the frames it keeps (the JAX
    package's ``_GroupNormAll`` with ``mask``); every frame is normalised.
    With ``axis`` the masked count and first moment, then the second
    central moment, are summed over the processes of that axis
    (``parallel/collectives.py:psum``), so each process of the
    sequence-sharded frontend normalises its window with the global
    moments.  The moments and the affine are f32 whatever x's dtype, and
    the result is cast back to it."""

    def __init__(self, dim: int):
        super().__init__(1, dim, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                axis: Optional[str] = None) -> torch.Tensor:
        if mask is None and axis is None:
            return F.group_norm(x.float(), 1, self.weight, self.bias, self.eps).to(x.dtype)
        # the moments from per-frame channel sums, the second one a chunk of
        # frames at a time, and the affine in place without autograd: the
        # norm then holds two maps of x's size, as F.group_norm does
        x32 = x.float()
        m = torch.ones_like(x32[:, :1]) if mask is None else mask.float()[:, None, :]  # [B, 1, T]
        cnt = m.sum(dim=(1, 2), keepdim=True) * x.shape[1]
        s1 = (x32.sum(1, keepdim=True) * m).sum(dim=(1, 2), keepdim=True)
        if axis is not None:
            cnt, s1 = collectives.psum_tensors([cnt, s1], axis)
        cnt = torch.clamp(cnt, min=1.0)
        mean = s1 / cnt
        s2 = sum(((x32[..., i:i + MOMENT_CHUNK] - mean).square().sum(1, keepdim=True) * m[..., i:i + MOMENT_CHUNK])
                 .sum(dim=(1, 2), keepdim=True) for i in range(0, x.shape[-1], MOMENT_CHUNK))
        if axis is not None:
            s2 = collectives.psum(s2, axis)
        var = s2 / cnt
        d, scale = x32 - mean, torch.rsqrt(var + self.eps)
        if torch.is_grad_enabled():
            return (d * scale * self.weight[:, None] + self.bias[:, None]).to(x.dtype)
        return d.mul_(scale).mul_(self.weight[:, None]).add_(self.bias[:, None]).to(x.dtype)


class SeqShardCtx(NamedTuple):
    """Which window of the sequence-sharded signal this process holds and
    the global frame bookkeeping its group norms need to count each output
    frame once (``parallel/seq_shard.py``); the JAX package's fields."""

    axis_name: str
    win_index: int  # this process's window
    n_windows: int
    frames_per_window: int  # m: final-layer output frames each window owns
    orig_len: int  # sample count of the whole signal, before padding

    def owned(self, n_frames: int, rf: int, jump: int, total_jump: int, device=None) -> torch.Tensor:
        """[n_frames] bool: the frames of a layer (receptive field ``rf``,
        hop ``jump`` samples) that this window counts in its group norm: its
        first m·total_jump/jump (the next window computes the rest again),
        or all of them in the last window, none past the whole signal's
        last frame of that layer (JAX audio_encoder.py:162-173)."""
        frames = torch.arange(n_frames, device=device)
        owned = self.frames_per_window * (total_jump // jump)
        last = self.win_index == self.n_windows - 1
        n_out = (self.orig_len - rf) // jump + 1
        return ((frames < owned) | last) & (self.win_index * owned + frames < n_out)


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

    def forward(self, wav: torch.Tensor, seq_ctx: Optional[SeqShardCtx] = None, n_valid=None) -> torch.Tensor:
        """``n_valid`` (an int or a [B] tensor: the samples before zero
        padding) gives every group norm masked moments over the frames whose
        receptive field lies in the real signal, as the JAX package's
        ``ConvFeatureExtractor`` does; the first ``feature_frames(n_valid)``
        frames then equal the extractor's on the unpadded signal.

        ``seq_ctx``: ``wav`` is one window of a longer signal
        (``parallel/seq_shard.py``).  Each layer's group norm then counts
        the frames this window owns (not the halo the next window computes
        again, not the frames of the last window's padding) and sums its
        moments over the context's axis (JAX ``:162-173``); ``n_valid``
        applies only without it, as in JAX."""
        dt = self.dtype
        x = wav[:, None, :]
        n = None if n_valid is None or seq_ctx is not None else (
            torch.as_tensor(n_valid, device=wav.device).reshape(-1, 1))
        total_jump = math.prod(conv.stride[0] for conv in (layer[0] for layer in self.conv_layers))
        rf, jump = 1, 1
        for layer in self.conv_layers:
            conv, norm = layer[0], layer[2]
            x = F.conv1d(x.to(dt), conv.weight.to(dt), None, conv.stride)
            rf += (conv.kernel_size[0] - 1) * jump
            jump *= conv.stride[0]
            mask = axis = None
            if n is not None:
                frames = torch.arange(x.shape[-1], device=wav.device)
                mask = (frames[None] < (n - rf) // jump + 1).float().expand(x.shape[0], -1)
            if seq_ctx is not None:
                own = seq_ctx.owned(x.shape[-1], rf, jump, total_jump, wav.device)
                mask, axis = own.float()[None].expand(x.shape[0], -1), seq_ctx.axis_name
            x = norm(x, mask, axis)  # one statement each: the conv's output is freed before the ReLU's
            x = torch.relu(x)
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


class Wav2VecDownsampler(nn.Module):
    """100 Hz wav2vec features -> a target frame rate (reference:
    audio_encoder.py:48-74; JAX audio_encoder.py:279): causal conv 3, ReLU,
    linear resize to (T + target) // 2, causal conv 3, linear resize to
    target, LayerNorm.  [B, T, in_dim] -> [B, target, dim].

    The resizes are ``F.interpolate(mode="linear", align_corners=False)``,
    the reference's.  The JAX ``interp_to`` agrees with it when it
    shrinks, the real use (100 Hz -> 30 fps); when it grows, JAX does not
    clamp the first rows' negative source position and extrapolates
    (ROADMAP, faults in the JAX package)."""

    def __init__(self, dim: int = 512, in_dim: int = 512, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(in_dim, dim, 3, device=device)
        self.conv2 = nn.Conv1d(dim, dim, 3, device=device)
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``, as the JAX package initialises:
        conv weights lecun-normal, biases 0, the norm identity."""
        for conv in (self.conv1, self.conv2):
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=generator)
            conv.bias.zero_()
        self.norm.reset_parameters()

    def forward(self, x: torch.Tensor, target_length: int) -> torch.Tensor:
        x = torch.relu(causal_conv1d(x, self.conv1.weight.permute(2, 1, 0), self.conv1.bias))
        x = F.interpolate(x.transpose(1, 2), size=(x.shape[1] + target_length) // 2, mode="linear",
                          align_corners=False).transpose(1, 2)
        x = causal_conv1d(x, self.conv2.weight.permute(2, 1, 0), self.conv2.bias)
        x = F.interpolate(x.transpose(1, 2), size=target_length, mode="linear",
                          align_corners=False).transpose(1, 2)
        return self.norm(x)


TCN_RECEPTIVE_FIELD = 25
TCN_KEEP = 0.8  # the TCN's dropout keeps 80% of its activations


def draw_keep(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """AudioTcn's dropout keep mask, True with probability ``TCN_KEEP``: the
    one place the TCN draws (tests replace it by the JAX package's masks)."""
    return torch.rand(shape, generator=generator, device=device) < TCN_KEEP


class AudioTcn(nn.Module):
    """Log-mel + wav2vec features -> a causal dilated TCN audio encoding
    (reference: audio_encoder.py:78-194; JAX audio_encoder.py:311):
    [B, T, 1600] 48 kHz frames -> [B, T, encoding_dim].

    - mel branch: 48 -> 24 kHz, ``melspectrogram`` (80 mels, hop 400, so two
      frames a visual frame), frame 0 dropped, ``log(max(mel, 1e-10))``, the
      two frames of a visual frame side by side: 160 channels, the first
      frame's 80 first.
    - wav2vec branch: 48 -> 16 kHz (no left pad), the frozen wav2vec_large
      extractor and aggregator (no graph: the JAX stop_gradient), a causal
      conv 3 to 256, a linear resize with aligned corners to T.
    - TCN: the concatenation left-padded by 24 frames, six valid dilated
      convs (dilations 1 2 3 1 2 3, receptive field 25), each followed by a
      leaky ReLU 0.2 and, in training, dropout keeping 80% (masks from
      ``draw_keep`` with the caller's generator); where a conv keeps the
      width, the output is the mean of its input's last frames and its own.
      A final 1x1 conv.
    """

    def __init__(self, encoding_dim: int = 128, use_melspec: bool = True, use_wav2vec: bool = True,
                 device=None):
        super().__init__()
        self.use_melspec, self.use_wav2vec = use_melspec, use_wav2vec
        if use_wav2vec:
            self.wav2vec_extractor = ConvFeatureExtractor().to(device)
            self.wav2vec_aggregator = ConvAggregator().to(device)
            self.w2v_post = nn.Conv1d(512, 256, 3, device=device)
        e = encoding_dim
        cin = 160 * use_melspec + 256 * use_wav2vec
        specs = [(cin, max(256, e), 1), (max(256, e), e, 2), (e, e, 3), (e, e, 1), (e, e, 2), (e, e, 3)]
        self.tcn = nn.ModuleList(nn.Conv1d(ci, co, 3, dilation=d, device=device) for ci, co, d in specs)
        self.final = nn.Conv1d(e, e, 1, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init from ``generator``, as the JAX package initialises:
        conv weights lecun-normal, biases 0, group norms identity."""
        for name, p in self.named_parameters():
            if p.dim() == 3:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def features(self, audio_frames: torch.Tensor) -> torch.Tensor:
        """[B, T, 1600] -> the TCN's input [B, 160 + 256, T] (as many of the
        two branches as are on)."""
        B, T, _ = audio_frames.shape
        wav = audio_frames.reshape(B, -1)
        feats = []
        if self.use_melspec:
            mel = melspectrogram(resample(wav, 48_000, 24_000))[:, :, 1:2 * T + 1]  # drop frame 0
            mel = torch.log(torch.clamp(mel, min=1e-10))
            feats.append(mel.reshape(B, 80, T, 2).permute(0, 3, 1, 2).reshape(B, 160, T))
        if self.use_wav2vec:
            with torch.no_grad():
                c = self.wav2vec_aggregator(self.wav2vec_extractor(resample(wav, 48_000, WAV2VEC_SR)))
            c = causal_conv1d(c, self.w2v_post.weight.permute(2, 1, 0), self.w2v_post.bias)
            feats.append(F.interpolate(c.transpose(1, 2), size=T, mode="linear", align_corners=True))
        return torch.cat(feats, dim=1)

    def forward(self, audio_frames: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.pad(self.features(audio_frames), (TCN_RECEPTIVE_FIELD - 1, 0))
        for conv in self.tcn:
            y = F.leaky_relu(conv(x), 0.2)
            if self.training:
                y = y * draw_keep(y.shape, generator, y.device) / TCN_KEEP
            x = (x[..., -y.shape[-1]:] + y) / 2.0 if x.shape[1] == y.shape[1] else y
        return self.final(x).transpose(1, 2)
