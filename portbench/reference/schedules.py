"""Beta schedules and precomputed diffusion coefficients.

Counterpart of ``audio2photoreal_tpu/diffusion/schedules.py`` (reference:
diffusion/gaussian_diffusion.py:26-64, 96-214): the tables are computed in
float64 numpy and stored as float32 numpy, as in the JAX package;
``to_device`` turns them into tensors once per sampling loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def named_betas(schedule: str, steps: int, scale_1000: bool = True) -> np.ndarray:
    """"linear" (DDPM, 1e-4..0.02 at 1000 steps) or "cosine" (Nichol-Dhariwal
    squared-cosine alphabar, beta clipped at 0.999)."""
    if schedule == "linear":
        scale = (1000.0 / steps) if scale_1000 else 1.0
        return np.linspace(scale * 1e-4, scale * 2e-2, steps, dtype=np.float64)
    if schedule == "cosine":
        def alpha_bar(t: float) -> float:
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = []
        for i in range(steps):
            t1, t2 = i / steps, (i + 1) / steps
            betas.append(min(1.0 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.asarray(betas, dtype=np.float64)
    raise ValueError(f"unknown beta schedule {schedule!r}")


class Schedule(NamedTuple):
    """Per-timestep coefficients, each [T]: float32 numpy arrays, or tensors
    after ``to_device``.  ``timestep_map`` maps a respaced index to the
    original-schedule timestep the denoiser is called with."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    alphas_cumprod_next: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    timestep_map: np.ndarray  # int [T]

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to_device(self, device) -> "Schedule":
        return Schedule(*(torch.as_tensor(np.asarray(a), device=device) for a in self))


def schedule_from_betas(betas: np.ndarray, timestep_map: np.ndarray | None = None) -> Schedule:
    betas = np.asarray(betas, dtype=np.float64)
    (T,) = betas.shape
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    # log clipped because posterior variance is 0 at t=0
    post_logvar = np.log(np.append(post_var[1], post_var[1:]))
    if timestep_map is None:
        timestep_map = np.arange(T)

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    return Schedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        alphas_cumprod_next=f32(acp_next),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(post_logvar),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        timestep_map=np.asarray(timestep_map, dtype=np.int64),
    )


def make_schedule(schedule: str = "cosine", steps: int = 1000) -> Schedule:
    return schedule_from_betas(named_betas(schedule, steps))


def extract(coefs: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep scalars as [B, 1, ..., 1] for broadcasting."""
    out = coefs[t].to(torch.float32)
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))
