"""Polyphase audio resampling (torchaudio.transforms.Resample equivalent).

Counterpart of ``audio2photoreal_tpu/ops/resample.py``: the same windowed
sinc-Hann phase bank, run as one strided conv.  The signal is padded with
``width`` zeros on the left and ``width + orig`` on the right, and the
output is cropped to ``ceil(T * new / orig)``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=8)
def _resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> Tuple[np.ndarray, int, int, int]:
    """Phase bank [new/gcd, K] (one output phase per row), torchaudio's
    construction; returns (kernels, width, orig, new)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig  # [1, K]
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx  # [new, K]
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernels.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample the last axis: [..., T] -> [..., ceil(T * new / orig)]."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig, new = _resample_kernel(orig_freq, new_freq)
    lead = x.shape[:-1]
    T = x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, T), (width, width + orig))  # [B, 1, T + pads]
    w = torch.as_tensor(kernels, dtype=x.dtype, device=x.device)[:, None, :]  # [new, 1, K]
    y = F.conv1d(xb, w, stride=orig)  # [B, new, T']
    y = y.transpose(1, 2).reshape(lead + (-1,))  # phases interleave along time
    target_len = int(math.ceil(new * T / orig))
    return y[..., :target_len]
