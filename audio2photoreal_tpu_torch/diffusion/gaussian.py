"""q/p diffusion math the DDIM loop needs.

Counterpart of ``audio2photoreal_tpu/diffusion/gaussian.py`` (reference:
diffusion/gaussian_diffusion.py:328-356).  ``s`` is a ``Schedule`` of
tensors (``Schedule.to_device``); ``x`` is [B, ...] and ``t`` int [B].
"""

from __future__ import annotations

from typing import Optional

import torch

from audio2photoreal_tpu_torch.diffusion.schedules import Schedule, extract


def predict_x0_from_eps(s: Schedule, xt: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
    return (
        extract(s.sqrt_recip_alphas_cumprod, t, xt.dim()) * xt
        - extract(s.sqrt_recipm1_alphas_cumprod, t, xt.dim()) * eps
    )


def predict_eps_from_x0(s: Schedule, xt: torch.Tensor, t: torch.Tensor, x0: torch.Tensor):
    return (
        extract(s.sqrt_recip_alphas_cumprod, t, xt.dim()) * xt - x0
    ) / extract(s.sqrt_recipm1_alphas_cumprod, t, xt.dim())


def predict_x0_from_v(s: Schedule, xt: torch.Tensor, t: torch.Tensor, v: torch.Tensor):
    """v-parameterization: v = sqrt(abar) eps - sqrt(1 - abar) x0."""
    return (
        extract(s.sqrt_alphas_cumprod, t, xt.dim()) * xt
        - extract(s.sqrt_one_minus_alphas_cumprod, t, xt.dim()) * v
    )


def model_prediction_to_x0(
    s: Schedule,
    predict: str,
    model_out: torch.Tensor,
    xt: torch.Tensor,
    t: torch.Tensor,
    clip: Optional[float] = None,
) -> torch.Tensor:
    if predict == "xstart":
        x0 = model_out
    elif predict == "eps":
        x0 = predict_x0_from_eps(s, xt, t, model_out)
    elif predict == "v":
        x0 = predict_x0_from_v(s, xt, t, model_out)
    else:
        raise ValueError(f"unknown prediction type {predict!r}")
    if clip is not None:
        x0 = torch.clamp(x0, -clip, clip)
    return x0
