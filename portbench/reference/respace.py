"""Timestep respacing.

Counterpart of ``audio2photoreal_tpu/diffusion/respace.py``, numpy only.
Re-derivation of the reference's SpacedDiffusion/space_timesteps
(reference: diffusion/respace.py:21-145).  Instead of wrapping the model to
remap timesteps at call time, we precompute a respaced `Schedule` whose
`timestep_map[i]` is the original-schedule timestep — samplers pass
``timestep_map[i]`` to the model and index coefficients with ``i``.
"""

from __future__ import annotations

from typing import Sequence, Set, Union

import numpy as np

from portbench.reference.schedules import Schedule, named_betas, schedule_from_betas


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Which original timesteps to keep.

    "ddimN" → the stride-based DDIM selection; otherwise per-section counts
    (e.g. "10,15,20" splits the schedule into 3 equal sections).
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot make exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, out = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            out.append(start + round(cur))
            cur += stride
        start += size
    return set(out)


def respaced_schedule(
    base_schedule: str,
    base_steps: int,
    section_counts: Union[str, Sequence[int]],
) -> Schedule:
    """Schedule over the kept subset, with betas re-derived from alphabar
    ratios so the q/p math stays exact (respace.py:98-107)."""
    betas = named_betas(base_schedule, base_steps)
    acp = np.cumprod(1.0 - betas)
    kept = sorted(space_timesteps(base_steps, section_counts))
    new_betas, last = [], 1.0
    for t in kept:
        new_betas.append(1.0 - acp[t] / last)
        last = acp[t]
    return schedule_from_betas(np.asarray(new_betas), timestep_map=np.asarray(kept))


def maybe_respaced(base_schedule: str, base_steps: int, respacing: str) -> Schedule:
    if respacing:
        return respaced_schedule(base_schedule, base_steps, respacing)
    return schedule_from_betas(named_betas(base_schedule, base_steps))
