"""Mel spectrogram (torchaudio.transforms.MelSpectrogram equivalent).

Counterpart of ``audio2photoreal_tpu/ops/melspec.py``, used by the AudioTcn
conditioning encoder (reference: model/modules/audio_encoder.py:95-104:
24 kHz, n_fft 1024, win 800, hop 400, 80 mels, so two feature frames per
30 fps visual frame).  The filterbank is the HTK mel scale with no area
normalisation, built in numpy as the JAX package builds it.  The STFT is
``torch.stft``: reflect-padded by n_fft/2 on each side, a periodic Hann
window of ``win_length`` centred in ``n_fft``, power ``|X|^2``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] triangular filters on the HTK mel scale."""
    fmax = fmax or sr / 2
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    fpts = mel_to_hz(mels)
    fb = np.zeros((n_freqs, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = fpts[m], fpts[m + 1], fpts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.clip(np.minimum(up, down), 0, None)
    return fb


def melspectrogram(
    wav: torch.Tensor,  # [B, S]
    sr: int = 24_000,
    n_fft: int = 1024,
    win_length: int = 800,
    hop_length: int = 400,
    n_mels: int = 80,
) -> torch.Tensor:
    """-> power mel spectrogram [B, n_mels, n_frames] (torchaudio's layout,
    centre-padded: n_frames = 1 + S // hop_length)."""
    window = torch.hann_window(win_length, periodic=True, dtype=wav.dtype, device=wav.device)
    spec = torch.stft(wav, n_fft, hop_length=hop_length, win_length=win_length, window=window,
                      center=True, pad_mode="reflect", return_complex=True)  # [B, n_freqs, n_frames]
    power = spec.real.square() + spec.imag.square()
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), dtype=wav.dtype, device=wav.device)
    return torch.einsum("bft,fm->bmt", power, fb)
