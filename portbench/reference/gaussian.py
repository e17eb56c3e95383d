"""The diffusion math the reference needs (reference:
diffusion/gaussian_diffusion.py: q_sample:215, the _predict helpers:328-356):
the forward process and the model output's x0 and eps.  ``s`` is a
``Schedule`` of tensors; ``x`` is [B, ...] and ``t`` int [B].
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.schedules import Schedule, extract


def q_sample(s: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Diffuse x0 to x_t: sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    return (
        extract(s.sqrt_alphas_cumprod, t, x0.dim()) * x0
        + extract(s.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise
    )


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
