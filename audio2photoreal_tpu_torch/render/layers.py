"""Weight-normalized conv/linear layers, NCHW.

Counterpart of ``audio2photoreal_tpu/render/layers.py`` (reference:
visualize/ca_body/nn/layers.py): ``LinearWN`` (:422), ``Conv2dWN`` /
``Conv2dWNUB`` (weight norm + UNTIED per-pixel bias, :126-290) and
``ConvTranspose2dWNUB`` (:292-420), under the reference's parameter names
``weight_v``, ``weight_g``, ``bias``.

Weight norm here is the reference's ``weight_norm_wrapper(g_dim, v_dim=None)``:
one GLOBAL Frobenius norm of ``v`` with a per-output-channel ``g``, i.e.
w = v · (g / ‖v‖_F) — not ``torch.nn.utils.weight_norm``'s per-channel norm.
Untied biases are [C, H, W].  The JAX package's space-to-depth forms are TPU
layout algebra with identical math and are not ported.

The renderer's compute dtype (the JAX package's ``render_compute_dtype`` /
``compute_dtype``, layers.py:25-41): inside ``render_compute_dtype(dtype)``
every weight-norm layer computes its weight in f32 from the f32 parameters
and casts it, and casts its input and bias, so the layer runs in ``dtype``
and returns it.  The setting is one module-level stack, not a thread's own,
so a render driven from any thread sees it.  The default is f32, in which
every cast is the identity.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


_COMPUTE_DTYPE = [torch.float32]


@contextlib.contextmanager
def render_compute_dtype(dtype: torch.dtype):
    """Run the renderer's weight-norm layers in ``dtype`` inside the block
    (parameters stay f32); the previous dtype is back after it, also after
    an exception."""
    _COMPUTE_DTYPE.append(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.pop()


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE[-1]


def _wn(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g (shaped to broadcast over v's out-channel dim) · v / ‖v‖_F, in f32,
    cast to the compute dtype."""
    norm = torch.sqrt((v * v).sum() + 1e-12)
    return (v * (g / norm)).to(compute_dtype())


class LinearWN(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.normal_(self.weight_v, 0.0, in_features**-0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype()
        return F.linear(x.to(cd), _wn(self.weight_v, self.weight_g), self.bias.to(cd))


class Conv2dWN(nn.Module):
    """Weight-norm conv with a tied bias [C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        fan_in = in_channels // groups * kernel_size**2
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight_v, 0.0, fan_in**-0.5)

    def weight(self) -> torch.Tensor:
        return _wn(self.weight_v, self.weight_g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype()
        return F.conv2d(x.to(cd), self.weight(), self.bias.to(cd), self.stride, self.padding, 1, self.groups)


class Conv2dWNUB(Conv2dWN):
    """Weight-norm conv with an untied (per-pixel) bias [C, H, W] — the
    reference's workhorse layer (layers.py:243-290)."""

    def __init__(self, in_channels: int, out_channels: int, height: int, width: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, groups)
        self.bias = nn.Parameter(torch.zeros(out_channels, height, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype()
        out = F.conv2d(x.to(cd), self.weight(), None, self.stride, self.padding, 1, self.groups)
        return out + self.bias[None].to(cd)


class ConvTranspose2dWNUB(nn.Module):
    """Weight-norm transpose conv, weight [Cin, Cout, k, k] with ``g`` over
    dim 1 (reference: g_dim=1, v_dim=None), untied bias [Cout, H, W]."""

    def __init__(self, in_channels: int, out_channels: int, height: int, width: int,
                 kernel_size: int = 4, stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(1, out_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels, height, width))
        nn.init.normal_(self.weight_v, 0.0, (in_channels * kernel_size**2) ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = compute_dtype()
        w = _wn(self.weight_v, self.weight_g)
        return F.conv_transpose2d(x.to(cd), w, None, self.stride, self.padding) + self.bias[None].to(cd)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') on [B, C, H, W] (no antialiasing)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C·r², H, W] → [B, C, H·r, W·r] (torch.nn.PixelShuffle)."""
    return F.pixel_shuffle(x, r)


def tile2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, F] → [B, F, size, size] (blocks.py:699-712)."""
    return x[:, :, None, None].expand(-1, -1, size, size)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Random init from ``generator``: ``weight_v`` N(0, 1/fan_in), ``weight_g``
    1, biases 0 — the JAX package's init (the global norm makes the scale of
    ``v`` irrelevant)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight_v"):
                fan_in = p[0].numel() if p.dim() == 2 else p.shape[1] * p.shape[2] * p.shape[3]
                p.normal_(0.0, fan_in**-0.5, generator=generator)
            elif name.endswith("weight_g"):
                p.fill_(1.0)
            else:
                p.zero_()
