"""The samplers: DDIM, ancestral and PLMS.

Counterpart of ``audio2photoreal_tpu/diffusion/sampling.py`` (reference:
gaussian_diffusion.py: p_sample_loop:434-616, ddim_sample_loop:667-936,
ddim_reverse_sample:777-813, plms_sample_loop:938-1145).  Each JAX
``lax.scan`` becomes a Python loop under ``torch.no_grad()``.
``model_fn(x, t)`` receives ORIGINAL-schedule timesteps [B]; coefficients
are looked up with the respaced index.  The step noise of the ancestral
sampler (and of DDIM at ``eta > 0``) comes from ``draw_step_noise``, the one
place it is drawn, from the ``generator`` handed in; for the same seed it
differs from the JAX package's ``jax.random`` draws, so the tests replace
that function with JAX's noise.
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


def draw_step_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One step's noise ~ N(0, I)."""
    return torch.randn(shape, generator=generator, device=device)


def _step_t(st: Schedule, i: int, batch: int, device):
    """Respaced index i -> (coefficient index t [B], model timestep [B])."""
    t = torch.full((batch,), i, dtype=torch.long, device=device)
    return t, st.timestep_map[t]


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
        t, t_model = _step_t(st, i, B, x.device)
        out = model_fn(x, t_model)
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
            x = x + sigma * draw_step_noise(x.shape, generator, x.device)
    return SampleResult(sample=x, pred_xstart=x0)


def ddim_reverse_step(
    s: Schedule,  # tensors on x's device
    predict: str,
    model_out: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    clip: Optional[float] = None,
) -> torch.Tensor:
    """Deterministic encoding x_t -> x_{t+1} (gaussian_diffusion.py:777-813)."""
    x0 = gaussian.model_prediction_to_x0(s, predict, model_out, x, t, clip)
    eps = gaussian.predict_eps_from_x0(s, x, t, x0)
    abar_next = extract(s.alphas_cumprod_next, t, x.dim())
    return x0 * torch.sqrt(abar_next) + torch.sqrt(1.0 - abar_next) * eps


@torch.no_grad()
def p_sample_loop(
    s: Schedule,
    predict: str,
    var_type: str,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    *,
    clip: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> SampleResult:
    """Ancestral sampling (gaussian_diffusion.py:434-616, the corrected math
    of the JAX package: the reference's non-DDIM path reads an undefined
    variable at :476); the step noise from ``generator``, none at t = 0."""
    st = s.to_device(x_T.device)
    B = x_T.shape[0]
    x, x0 = x_T, None
    for i in range(s.num_timesteps - 1, -1, -1):
        t, t_model = _step_t(st, i, B, x.device)
        pmv = gaussian.p_mean_variance(st, predict, var_type, model_fn(x, t_model), x, t, clip)
        x0 = pmv.pred_xstart
        x = pmv.mean
        if i > 0:
            x = x + torch.exp(0.5 * pmv.log_variance) * draw_step_noise(x.shape, generator, x.device)
    return SampleResult(sample=x, pred_xstart=x0)


@torch.no_grad()
def plms_sample_loop(
    s: Schedule,
    predict: str,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    *,
    order: int = 2,
    clip: Optional[float] = None,
) -> SampleResult:
    """Pseudo linear multi-step (gaussian_diffusion.py:938-1145), orders
    1-4 (the reference's default 2): the first step with ``order`` > 1 is
    the Pseudo Improved Euler warm-up, a second model evaluation at
    (mean_pred, t - 1) averaged into eps (:992-1005); later steps are
    Adams-Bashforth over the last min(order, steps so far) eps (:1008-1034);
    at t = 0 the transition returns pred_xstart itself (:1038-1039)."""
    if not 1 <= order <= 4:
        raise ValueError("order must be 1-4")
    st = s.to_device(x_T.device)
    T, B = s.num_timesteps, x_T.shape[0]

    def get_eps(x, i):
        t, t_model = _step_t(st, i, B, x.device)
        x0 = gaussian.model_prediction_to_x0(st, predict, model_fn(x, t_model), x, t, clip)
        return gaussian.predict_eps_from_x0(st, x, t, x0), x0

    def ab_transfer(x, eps_prime, i):
        # x_{t-1} from x_t through the x0 consistent with eps_prime
        t = torch.full((B,), i, dtype=torch.long, device=x.device)
        abar_prev = extract(st.alphas_cumprod_prev, t, x.dim())
        x0p = gaussian.predict_x0_from_eps(st, x, t, eps_prime)
        return x0p * torch.sqrt(abar_prev) + torch.sqrt(1.0 - abar_prev) * eps_prime

    # the first step (i = T - 1), with its warm-up
    i0 = T - 1
    eps0, x0 = get_eps(x_T, i0)
    if order > 1:
        eps2, _ = get_eps(ab_transfer(x_T, eps0, i0), max(i0 - 1, 0))
        x = ab_transfer(x_T, (eps0 + eps2) / 2, i0)
    else:
        x = ab_transfer(x_T, eps0, i0)
    if i0 == 0:
        return SampleResult(sample=x0, pred_xstart=x0)

    hist, n = [eps0], 1  # the previous eps, most recent first
    for i in range(T - 2, -1, -1):
        eps, x0 = get_eps(x, i)
        e = [eps] + hist + [hist[0]] * 2  # e1..e3 past the history are never read
        by_order = (
            e[0],
            (3 * e[0] - e[1]) / 2,
            (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12,
            (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24,
        )
        eps_prime = by_order[min(order - 1, n)]
        x = ab_transfer(x, eps_prime, i) if i > 0 else x0
        hist = ([eps] + hist)[: max(order - 1, 1)]
        n = min(n + 1, order - 1)
    return SampleResult(sample=x, pred_xstart=x0)


SAMPLERS = {
    "ddim": ddim_sample_loop,
    "ancestral": p_sample_loop,
    "plms": plms_sample_loop,
}
