"""Timestep samplers for diffusion training.

Counterpart of ``audio2photoreal_tpu/diffusion/tsample.py`` (reference:
diffusion/resample.py, UniformSampler:75 and LossSecondMomentResampler:138).
The loss-aware sampler's history is a small host-side state ([T, 10] f32)
that the train step updates after each step; draws come from an explicit
CPU generator, so a run is reproducible from its seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def uniform_sample(generator: Optional[torch.Generator], num_timesteps: int,
                   batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """t ~ U{0, .., T-1} [batch] int64 and unit weights, on the CPU."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator)
    return t, torch.ones((batch,), dtype=torch.float32)


class LossSecondMomentState(NamedTuple):
    history: torch.Tensor  # [T, history_per_term] float32
    counts: torch.Tensor  # [T] int64

    @classmethod
    def init(cls, num_timesteps: int, history_per_term: int = 10) -> "LossSecondMomentState":
        return cls(torch.zeros((num_timesteps, history_per_term)),
                   torch.zeros((num_timesteps,), dtype=torch.int64))


def loss_second_moment_weights(state: LossSecondMomentState, uniform_prob: float = 0.001) -> torch.Tensor:
    """Per-timestep sampling probabilities (resample.py:144-157): uniform
    until every timestep holds a full history."""
    T = state.history.shape[0]
    if not bool((state.counts == state.history.shape[1]).all()):
        return torch.full((T,), 1.0 / T)
    w = torch.sqrt((state.history**2).mean(-1))
    w = w / torch.clamp(w.sum(), min=1e-12)
    return w * (1.0 - uniform_prob) + uniform_prob / T


def loss_second_moment_sample(generator: Optional[torch.Generator], state: LossSecondMomentState,
                              batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    p = loss_second_moment_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def loss_second_moment_update(state: LossSecondMomentState, t: torch.Tensor,
                              losses: torch.Tensor) -> LossSecondMomentState:
    """Append each (t, loss) pair, in order, to its timestep's ring buffer
    (shift left once full)."""
    history, counts = state.history.clone(), state.counts.clone()
    H = history.shape[1]
    for ti, li in zip(t.tolist(), losses.detach().float().cpu().tolist()):
        c = int(counts[ti])
        if c == H:
            history[ti] = torch.cat([history[ti, 1:], torch.tensor([li])])
        else:
            history[ti, c] = li
        counts[ti] = min(c + 1, H)
    return LossSecondMomentState(history, counts)
