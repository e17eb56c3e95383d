"""Diffusion training losses.

Counterpart of ``audio2photoreal_tpu/diffusion/losses.py`` (reference:
gaussian_diffusion.py:186-213, 1195-1271; diffusion/losses.py:18-83):
masked L2 over valid x non-missing frames, the optional velocity term, and
the variational-bound diagnostic, computed without a graph.

Layout: x is [B, T, C]; masks broadcast as [B, T, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from audio2photoreal_tpu_torch.diffusion import gaussian
from audio2photoreal_tpu_torch.diffusion.schedules import Schedule, extract


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error over the unmasked elements (mask 1 =
    valid): the sum over a sample divided by its count of valid elements."""
    diff2 = (a - b) ** 2 * mask
    sums = diff2.reshape(diff2.shape[0], -1).sum(-1)
    counts = torch.broadcast_to(mask, diff2.shape).reshape(diff2.shape[0], -1).sum(-1)
    return sums / torch.clamp(counts, min=1.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of values discretized to 1/255 bins."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


@torch.no_grad()
def vb_term(s: Schedule, predict: str, var_type: str, model_out, x0, xt, t) -> torch.Tensor:
    """Variational-bound diagnostic in bits, per sample (no gradient, as the
    reference computes it under no_grad)."""
    true_mean, _, true_logvar = gaussian.q_posterior_mean_variance(s, x0, xt, t)
    pmv = gaussian.p_mean_variance(s, predict, var_type, model_out, xt, t)
    kl = normal_kl(true_mean, true_logvar, pmv.mean, pmv.log_variance)
    kl = kl.reshape(kl.shape[0], -1).mean(-1) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(x0, means=pmv.mean, log_scales=0.5 * pmv.log_variance)
    nll = nll.reshape(nll.shape[0], -1).mean(-1) / math.log(2.0)
    return torch.where(t == 0, nll, kl)


def training_losses(
    s: Schedule,
    predict: str,
    model_out: torch.Tensor,
    x0: torch.Tensor,
    xt: torch.Tensor,
    t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    lambda_vel: float = 0.0,
    var_type: str = "fixed_small",
    with_vb: bool = True,
    vel_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-sample loss terms {mse, [vel_mse], [vb], loss}.  ``mask`` is
    [B, T, 1] valid x non-missing; ``vel_mask`` (validity only) masks the
    velocity term and defaults to ``mask``."""
    if mask is None:
        mask = torch.ones(x0.shape[:2] + (1,), dtype=x0.dtype, device=x0.device)
    if vel_mask is None:
        vel_mask = mask
    if predict == "xstart":
        target = x0
    elif predict == "eps":
        target = gaussian.predict_eps_from_x0(s, xt, t, x0)
    elif predict == "v":
        eps = gaussian.predict_eps_from_x0(s, xt, t, x0)
        target = (extract(s.sqrt_alphas_cumprod, t, x0.dim()) * eps
                  - extract(s.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * x0)
    else:
        raise ValueError(predict)

    terms: Dict[str, torch.Tensor] = {"mse": masked_l2(target, model_out, mask)}
    if lambda_vel > 0.0:
        # velocity on the x0-level prediction (only meaningful for xstart)
        pred_x0 = gaussian.model_prediction_to_x0(s, predict, model_out, xt, t)
        vel_t = target[:, 1:] - target[:, :-1] if predict == "xstart" else x0[:, 1:] - x0[:, :-1]
        terms["vel_mse"] = masked_l2(vel_t, pred_x0[:, 1:] - pred_x0[:, :-1], vel_mask[:, 1:])
    if with_vb:
        terms["vb"] = vb_term(s, predict, var_type, model_out.detach(), x0, xt, t)
    loss = terms["mse"]
    if "vel_mse" in terms:
        loss = loss + lambda_vel * terms["vel_mse"]
    terms["loss"] = loss
    return terms
