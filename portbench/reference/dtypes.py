"""Mixed-precision policy: (param, compute, output) dtypes.  Under
``"bfloat16"`` the parameters stay f32, every module casts its inputs and
its parameters to bf16 per call, sums run in f32 inside the products, and
the model's output is f32.
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
