"""The DDIM sampling loop.

Counterpart of ``audio2photoreal_tpu/diffusion/sampling.py:ddim_sample_loop``
(reference: gaussian_diffusion.py:667-936).  The JAX ``lax.scan`` becomes a
Python loop under ``torch.no_grad()``.  ``model_fn(x, t)`` receives
ORIGINAL-schedule timesteps [B]; coefficients are looked up with the
respaced index.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from audio2photoreal_tpu_torch.diffusion import gaussian
from audio2photoreal_tpu_torch.diffusion.schedules import Schedule, extract

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SampleResult(NamedTuple):
    sample: torch.Tensor  # x after the last transition
    pred_xstart: torch.Tensor  # the last step's x0 estimate (the reference returns
    # this, gaussian_diffusion.py:862)


@torch.no_grad()
def ddim_sample_loop(
    s: Schedule,
    predict: str,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    *,
    eta: float = 0.0,
    clip: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> SampleResult:
    """DDIM from x_T; with ``eta > 0`` the step noise comes from ``generator``."""
    st = s.to_device(x_T.device)
    B = x_T.shape[0]
    x, x0 = x_T, None
    for i in range(s.num_timesteps - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        out = model_fn(x, st.timestep_map[t])
        x0 = gaussian.model_prediction_to_x0(st, predict, out, x, t, clip)
        eps = gaussian.predict_eps_from_x0(st, x, t, x0)
        abar = extract(st.alphas_cumprod, t, x.dim())
        abar_prev = extract(st.alphas_cumprod_prev, t, x.dim())
        sigma = (
            eta
            * torch.sqrt((1.0 - abar_prev) / (1.0 - abar))
            * torch.sqrt(1.0 - abar / abar_prev)
        )
        x = x0 * torch.sqrt(abar_prev) + torch.sqrt(1.0 - abar_prev - sigma**2) * eps
        if eta > 0.0 and i > 0:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x = x + sigma * noise
    return SampleResult(sample=x, pred_xstart=x0)
