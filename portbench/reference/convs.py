"""1-D convolution helpers in B,T,C layout.

Counterpart of ``audio2photoreal_tpu/ops/convs.py``: ``F.conv1d`` behind the
JAX package's interface, input [B, T, Cin] and kernel [K, Cin, Cout].  A
module that stores a torch ``Conv1d`` weight [Cout, Cin, K] passes
``weight.permute(2, 1, 0)``; the two permutes cancel to a view of the
original storage, so no copy is made.  ``strided_conv_as_matmul`` is not
ported: it reshapes a strided conv for the TPU's matrix unit, and cuDNN
takes the strided conv as it is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,  # [B, T, Cin]
    kernel: torch.Tensor,  # [K, Cin, Cout]
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    padding: Tuple[int, int] = (0, 0),  # zeros on the left and right of T
) -> torch.Tensor:
    xc = x.transpose(1, 2)  # [B, Cin, T]
    if tuple(padding) != (0, 0):
        xc = F.pad(xc, tuple(padding))
    out = F.conv1d(xc, kernel.permute(2, 1, 0), bias, stride=stride, dilation=dilation)
    return out.transpose(1, 2)


def valid_conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
) -> torch.Tensor:
    """No padding (the wav2vec extractor's and the post-net's final 1x1 conv)."""
    return conv1d(x, kernel, bias, stride=stride, padding=(0, 0))
