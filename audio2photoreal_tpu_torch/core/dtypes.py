"""Mixed-precision policy.

A copy of ``audio2photoreal_tpu/core/dtypes.py`` that imports no JAX: a
(param, compute, output) dtype triple applied at module boundaries.  Under
``"bfloat16"`` the parameters and the optimizer state stay f32, every module
casts its inputs and its f32 parameters to bf16 per call (flax's
``dtype=``), sums run in f32 inside the products, and the model's output is
f32.  There is no loss scaling: bf16 keeps f32's exponent range.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


def default_policy(name: str = "bfloat16") -> DTypePolicy:
    """The policy a config's dtype string names: "bf16" / "bfloat16" compute
    in bf16, "f32" / "float32" in f32; anything else raises."""
    if name in ("bf16", "bfloat16"):
        return DTypePolicy()
    if name in ("f32", "float32"):
        return DTypePolicy(compute_dtype=torch.float32)
    raise ValueError(f"unknown dtype policy {name!r}")


def compute_dtype(name: str) -> torch.dtype:
    """The compute dtype of the policy ``name`` names."""
    return default_policy(name).compute_dtype
