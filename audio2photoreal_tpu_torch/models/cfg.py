"""Classifier-free guidance as one batched forward.

Counterpart of ``audio2photoreal_tpu/models/cfg.py`` (reference:
model/cfg_sampler.py:17-33): the conditional and unconditional branches are
stacked on the batch axis with keep_mask [1...1, 0...0], the denoiser runs
once, and out = uncond + scale * (cond - uncond).  ``guidance_scale`` is a
float, or a per-sample [B] tensor.
"""

from __future__ import annotations

from typing import Union

import torch

from audio2photoreal_tpu_torch.models.film_transformer import CondTokens, FiLMDenoiser


def _guide(out: torch.Tensor, B: int, guidance_scale) -> torch.Tensor:
    c, u = out[:B], out[B:]
    scale = guidance_scale
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        scale = scale.reshape((-1,) + (1,) * (c.dim() - 1))
    return u + scale * (c - u)


def _stack_cond(cond: CondTokens) -> CondTokens:
    return CondTokens(
        torch.cat([cond.cond_tokens] * 2),
        torch.cat([cond.pose_tokens] * 2) if cond.pose_tokens is not None else None,
    )


def _keep2(B: int, device) -> torch.Tensor:
    keep = torch.zeros(2 * B, dtype=torch.bool, device=device)
    keep[:B] = True
    return keep


def cfg_model_fn(
    model: FiLMDenoiser, cond: CondTokens, guidance_scale: Union[float, torch.Tensor]
):
    """`model_fn(x, t) -> out` for the samplers, through ``model.denoise``."""
    B = cond.cond_tokens.shape[0]
    device = cond.cond_tokens.device
    if not isinstance(guidance_scale, torch.Tensor) and guidance_scale == 1.0:
        keep = torch.ones(B, dtype=torch.bool, device=device)
        return lambda x, t: model.denoise(x, t, cond, keep)

    cond2, keep2 = _stack_cond(cond), _keep2(B, device)

    def model_fn(x, t):
        out = model.denoise(torch.cat([x, x]), torch.cat([t, t]), cond2, keep2)
        return _guide(out, x.shape[0], guidance_scale)

    return model_fn


def cfg_model_fn_cached(
    model: FiLMDenoiser, cond: CondTokens, guidance_scale: Union[float, torch.Tensor]
):
    """`cfg_model_fn` with the step-invariant conditioning work
    (``FiLMDenoiser.build_cond_cache``) done once, here, for both branches;
    each step then runs ``denoise_cached``."""
    B = cond.cond_tokens.shape[0]
    device = cond.cond_tokens.device
    if not isinstance(guidance_scale, torch.Tensor) and guidance_scale == 1.0:
        cache = model.build_cond_cache(cond, torch.ones(B, dtype=torch.bool, device=device))
        return lambda x, t: model.denoise_cached(x, t, cache)

    cache = model.build_cond_cache(_stack_cond(cond), _keep2(B, device))

    def model_fn(x, t):
        out = model.denoise_cached(torch.cat([x, x]), torch.cat([t, t]), cache)
        return _guide(out, x.shape[0], guidance_scale)

    return model_fn
