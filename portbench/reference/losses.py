"""The diffusion training loss (reference: gaussian_diffusion.py:1195-1271;
diffusion/losses.py:18-83): masked L2 over valid x non-missing frames and
the optional velocity term.  x is [B, T, C]; masks broadcast as [B, T, 1].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import gaussian
from portbench.reference.schedules import Schedule, extract


def masked_l2(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error over the unmasked elements (mask 1 =
    valid): the sum over a sample divided by its count of valid elements."""
    diff2 = (a - b) ** 2 * mask
    sums = diff2.reshape(diff2.shape[0], -1).sum(-1)
    counts = torch.broadcast_to(mask, diff2.shape).reshape(diff2.shape[0], -1).sum(-1)
    return sums / torch.clamp(counts, min=1.0)


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
    vel_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-sample loss terms {mse, [vel_mse], loss}.  ``mask`` is
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
    loss = terms["mse"]
    if "vel_mse" in terms:
        loss = loss + lambda_vel * terms["vel_mse"]
    terms["loss"] = loss
    return terms
