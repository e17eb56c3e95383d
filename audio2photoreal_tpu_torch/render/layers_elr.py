"""Equalized-learning-rate layers, antialiased downsampling and ConcatPyramid.

Counterpart of ``audio2photoreal_tpu/render/layers_elr.py`` (reference:
visualize/ca_body/nn/layers.py: ``LinearELR`` :606-647, ``Conv2dELR``
:649-770, ``ConcatPyramid`` :771-855, ``Downsample`` :873-940): the
StyleGAN-style runtime weight scale ``gain / sqrt(fan_in) * lr_mul`` and the
blur-pool of "Making Convolutional Networks Shift-Invariant Again".  The
shipped avatar does not use them; other ca_body configurations do.

NCHW activations and torch parameter layouts: ``LinearELR.weight`` [out,
in]; ``Conv2dELR.weight`` [Cout, Cin/g, k, k], or [Cin, Cout/g, k, k] with
``transpose`` (``conv_transpose2d``'s); an untied bias [Cout, H, W].
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

PAD_MODES = {"reflect": "reflect", "refl": "reflect", "replicate": "replicate", "repl": "replicate",
             "zero": "constant"}


def gaussian_kernel(ksize: int, std: Optional[float] = None) -> np.ndarray:
    """2-D Gaussian blur kernel [ksize, ksize] summing to 1 (layers.py:22-47:
    the default std makes the kernel's edge worth 5% of its centre)."""
    assert ksize % 2 == 1
    radius = ksize // 2
    if std is None:
        std = float(np.sqrt(-(radius**2) / (2 * np.log(0.05))))
    x = np.linspace(-radius, radius, ksize)
    g = np.exp(-(x**2) / (2 * std**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class LinearELR(nn.Module):
    """x @ (weight * gain / sqrt(in) * lr_mul).T + bias * bias_lr_mul."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, gain: Optional[float] = None,
                 lr_mul: float = 1.0, bias_lr_mul: Optional[float] = None, device=None):
        super().__init__()
        gain = math.sqrt(2.0) if gain is None else gain
        self.std = gain / math.sqrt(in_features) * lr_mul
        self.lr_mul = lr_mul
        self.bias_lr_mul = lr_mul if bias_lr_mul is None else bias_lr_mul
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """weight ~ N(0, 1/lr_mul^2), bias 0."""
        self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias * self.bias_lr_mul
        return F.linear(x, self.weight * self.std, bias)


def _box_sum(w: torch.Tensor) -> torch.Tensor:
    """The k x k kernel convolved with a 2 x 2 box: a (k+1) x (k+1) sum."""
    wp = F.pad(w, (1, 1, 1, 1))
    return wp[..., 1:, 1:] + wp[..., :-1, 1:] + wp[..., 1:, :-1] + wp[..., :-1, :-1]


class Conv2dELR(nn.Module):
    """ELR conv, or with ``transpose`` ELR transposed conv (output (H - 1)s -
    2p + k + output_padding), with an optional untied bias [Cout, height,
    width] and an optional 2 x 2 box filter fused into the kernel (the
    average on the plain conv, the sum on the transposed one, as in the
    JAX package).  The runtime scale's fan-in is k * k * Cin / groups."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, groups: int = 1, bias: bool = True,
                 untied: bool = False, height: int = 1, width: int = 1, gain: Optional[float] = None,
                 transpose: bool = False, fuse_box_filter: bool = False, lr_mul: float = 1.0,
                 bias_lr_mul: Optional[float] = None, device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.output_padding, self.groups = stride, padding, output_padding, groups
        self.transpose, self.fuse_box_filter = transpose, fuse_box_filter
        gain = math.sqrt(2.0) if gain is None else gain
        self.std = gain / math.sqrt(k * k * in_channels // groups) * lr_mul
        self.lr_mul = lr_mul
        self.bias_lr_mul = lr_mul if bias_lr_mul is None else bias_lr_mul
        shape = (in_channels, out_channels // groups, k, k) if transpose else (out_channels, in_channels // groups, k, k)
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        bias_shape = (out_channels, height, width) if untied else (out_channels,)
        self.bias = nn.Parameter(torch.empty(bias_shape, device=device)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """weight ~ N(0, 1/lr_mul^2), bias 0."""
        self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.transpose:
            w = _box_sum(w) if self.fuse_box_filter else w
            out = F.conv_transpose2d(x, w * self.std, None, self.stride, self.padding, self.output_padding,
                                     self.groups)
        else:
            w = _box_sum(w) * 0.25 if self.fuse_box_filter else w
            out = F.conv2d(x, w * self.std, None, self.stride, self.padding, 1, self.groups)
        if self.bias is None:
            return out
        b = self.bias * self.bias_lr_mul
        return out + (b[None] if b.dim() == 3 else b[None, :, None, None])


def blur_downsample(x: torch.Tensor, filt_size: int = 3, stride: int = 2, pad_type: str = "reflect",
                    pad_off: int = 0) -> torch.Tensor:
    """Antialiased downsampling of [B, C, H, W] (blur-pool; layers.py:873-940):
    pad (reflect, replicate or zero), then a depthwise binomial filter of
    ``filt_size`` taps a side at ``stride``; at ``filt_size`` 1 the stride
    alone."""
    C = x.shape[1]
    lo = (filt_size - 1) // 2 + pad_off
    hi = -(-(filt_size - 1) // 2) + pad_off
    xp = F.pad(x, (lo, hi, lo, hi), mode=PAD_MODES[pad_type])
    if filt_size == 1:
        return xp[:, :, ::stride, ::stride]
    a = np.asarray([math.comb(filt_size - 1, i) for i in range(filt_size)], np.float32)
    f = np.outer(a, a)
    f = torch.as_tensor((f / f.sum()).astype(np.float32)[None, None], dtype=x.dtype, device=x.device)
    return F.conv2d(xp, f.repeat(C, 1, 1, 1), stride=stride, groups=C)


def concat_pyramid(layers: Sequence[Callable[[torch.Tensor], torch.Tensor]], x: torch.Tensor, y: torch.Tensor,
                   every_other: bool = True, ksize: int = 7, kstd: Optional[float] = None,
                   transposed: bool = False) -> torch.Tensor:
    """ConcatPyramid (layers.py:771-855): run ``layers`` on ``x`` and
    concatenate, along the channels, a level of a Gaussian pyramid of ``y``
    before every layer (or every other one), the coarsest level first.
    Each level is a depthwise Gaussian blur of the one above, every second
    pixel kept; with ``transposed`` the finest level is ``y`` blurred and
    halved too."""
    C = y.shape[1]
    kern = torch.as_tensor(gaussian_kernel(ksize, kstd)[None, None], dtype=y.dtype, device=y.device).repeat(C, 1, 1, 1)

    def blur_half(img):
        return F.conv2d(img, kern, padding=ksize // 2, groups=C)[:, :, ::2, ::2]

    levels = -(-len(layers) // 2) if every_other else len(layers)
    pyramid = [blur_half(y) if transposed else y]
    for _ in range(levels - 1):
        pyramid.insert(0, blur_half(pyramid[0]))

    out = x
    for i, layer in enumerate(layers):
        if i % 2 == 0 or not every_other:
            out = torch.cat([out, pyramid[i // 2 if every_other else i]], dim=1)
        out = layer(out)
    return out
