from audio2photoreal_tpu_torch.diffusion.schedules import Schedule, make_schedule, named_betas
from audio2photoreal_tpu_torch.diffusion.respace import maybe_respaced, respaced_schedule, space_timesteps
from audio2photoreal_tpu_torch.diffusion import gaussian, sampling

__all__ = [
    "Schedule",
    "make_schedule",
    "named_betas",
    "maybe_respaced",
    "respaced_schedule",
    "space_timesteps",
    "gaussian",
    "sampling",
]
