"""q/p diffusion math of the DDIM loop and the training loss.

Counterpart of ``audio2photoreal_tpu/diffusion/gaussian.py`` (reference:
diffusion/gaussian_diffusion.py: q_sample:215, q_posterior_mean_variance:235,
p_mean_variance:259, the _predict helpers:328-356, condition_mean /
condition_score:358-412).  ``s`` is a ``Schedule``
of tensors (``Schedule.to_device``); ``x`` is [B, ...] and ``t`` int [B].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from audio2photoreal_tpu_torch.diffusion.schedules import Schedule, extract


def q_sample(s: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Diffuse x0 to x_t: sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    return (
        extract(s.sqrt_alphas_cumprod, t, x0.dim()) * x0
        + extract(s.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise
    )


def q_posterior_mean_variance(s: Schedule, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0): (mean, variance, clipped log-variance)."""
    mean = (
        extract(s.posterior_mean_coef1, t, x0.dim()) * x0
        + extract(s.posterior_mean_coef2, t, x0.dim()) * xt
    )
    var = extract(s.posterior_variance, t, x0.dim())
    logvar = extract(s.posterior_log_variance_clipped, t, x0.dim())
    return mean, var, logvar


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


class PMeanVar(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(
    s: Schedule,
    predict: str,
    var_type: str,
    model_out: torch.Tensor,
    xt: torch.Tensor,
    t: torch.Tensor,
    clip: Optional[float] = None,
) -> PMeanVar:
    """Model output -> p(x_{t-1} | x_t) moments, fixed-variance family."""
    x0 = model_prediction_to_x0(s, predict, model_out, xt, t, clip)
    mean, _, _ = q_posterior_mean_variance(s, x0, xt, t)
    if var_type == "fixed_small":
        var = extract(s.posterior_variance, t, xt.dim())
        logvar = extract(s.posterior_log_variance_clipped, t, xt.dim())
    elif var_type == "fixed_large":
        # betas with beta_0 replaced by posterior_variance[1] for stability
        betas = torch.cat([s.posterior_variance[1:2], s.betas[1:]])
        var = extract(betas, t, xt.dim())
        logvar = torch.log(torch.clamp(var, min=1e-20))
    else:
        raise ValueError(f"unknown var_type {var_type!r}")
    return PMeanVar(mean, var, logvar, x0)


def condition_mean(mean: torch.Tensor, variance: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Classifier-guidance mean shift: mean + variance * grad log p(y|x)
    (gaussian_diffusion.py:358-380)."""
    return mean + variance * grad


def condition_score(s: Schedule, xt: torch.Tensor, t: torch.Tensor, pred_x0: torch.Tensor,
                    grad: torch.Tensor) -> torch.Tensor:
    """Classifier-guided x0 re-estimate by the score route
    (gaussian_diffusion.py:382-412)."""
    eps = predict_eps_from_x0(s, xt, t, pred_x0)
    eps = eps - extract(s.sqrt_one_minus_alphas_cumprod, t, xt.dim()) * grad
    return predict_x0_from_eps(s, xt, t, eps)
