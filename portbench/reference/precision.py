"""The reference computed in a lower precision: the control of the check.

``Products(kind)`` is a torch function mode under which every matrix
product and convolution (``F.linear``, ``torch.matmul`` and ``@``,
``torch.bmm``, ``F.conv1d``) takes its floating operands rounded to
``kind`` and sums in f32, as the tensor cores do:

- ``"tf32"``: 10 mantissa bits, round to nearest even (TF32 in place of
  f32 with TF32 off);
- ``"bf16"``: bfloat16;
- ``"fp8"``: float8 e4m3 with one scale per tensor (its largest magnitude
  to 448), as fp8 training scales (fp8 in place of bf16).

Under autograd the rounding passes the gradient straight through, so the
backward's products take the rounded operands as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

KINDS = ("tf32", "bf16", "fp8")
FP8_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.float().contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_to(kind: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``kind`` and held in x's dtype."""
    if kind == "tf32":
        r = _round_tf32(x)
    elif kind == "bf16":
        r = x.to(torch.bfloat16).float()
    elif kind == "fp8":
        r = _round_fp8(x)
    else:
        raise ValueError(f"unknown precision {kind!r}; one of {KINDS}")
    r = r.to(x.dtype)
    return x + (r - x).detach() if x.requires_grad else r


_PRODUCTS = {F.linear: 2, torch.matmul: 2, torch.Tensor.matmul: 2, torch.Tensor.__matmul__: 2,
             torch.bmm: 2, F.conv1d: 2}


class Products(TorchFunctionMode):
    def __init__(self, kind: str):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown precision {kind!r}; one of {KINDS}")
        self.kind = kind

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _PRODUCTS.get(func, 0)
        if n:
            args = tuple(round_to(self.kind, a) if i < n and isinstance(a, torch.Tensor) and a.is_floating_point()
                         else a for i, a in enumerate(args))
        return func(*args, **kwargs)
