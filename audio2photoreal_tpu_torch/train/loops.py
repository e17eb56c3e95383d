"""The diffusion denoiser's train step.

Counterpart of ``audio2photoreal_tpu/train/loops.py:make_diffusion_train_step``
(reference: training_loop.py:174-215 + gaussian_diffusion.py:1195-1271):
sample t and noise, diffuse, run the training forward (pose or face, on raw
audio or on the feature cache's ``audio_features`` / ``lip_verts``), masked
L2 (+ velocity, masked by the batch's lengths, + the vb diagnostic),
backward, and one optimizer update unless the loss or the gradient norm is
not finite, in which case the update is skipped (the role of the
reference's fp16 NaN backoff).

Every random draw of a step comes from two generators the caller seeds for
that step: a CPU one (t, the guidance-dropout draws, one seed per dropout
site) and one on the model's device (the noise).  The step reads its metrics
back to the host once, which is also where it learns whether to update.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from audio2photoreal_tpu_torch.core.config import DiffusionConfig
from audio2photoreal_tpu_torch.diffusion import gaussian, losses, tsample
from audio2photoreal_tpu_torch.diffusion.schedules import Schedule
from audio2photoreal_tpu_torch.train.state import TrainState, global_norm

QUARTILES = 4


def validity_mask(batch: Dict[str, torch.Tensor], T: int) -> Optional[torch.Tensor]:
    """[B, T, 1] float mask of the frames ``batch["lengths"]`` counts as
    valid, or None when the batch has no lengths.  The velocity term is
    masked by validity alone, as the reference does
    (diffusion/losses.py:107-112): ``batch["mask"]`` also drops a face
    batch's missing frames, which the velocity term keeps.  The JAX
    package's step passes no velocity mask (its train/loops.py:85), so there
    the velocity term takes ``mask``; this step follows the reference."""
    lengths = batch.get("lengths")
    if lengths is None:
        return None
    frames = torch.arange(T, device=lengths.device)
    return (frames[None] < lengths.reshape(-1, 1)).to(batch["mask"].dtype)[..., None]


def diffusion_train_step(
    state: TrainState,
    schedule: Schedule,  # tensors on the model's device
    dcfg: DiffusionConfig,
    batch: Dict[str, torch.Tensor],  # on the model's device
    generator: Optional[torch.Generator] = None,  # CPU
    noise_generator: Optional[torch.Generator] = None,  # on the model's device
    *,
    t: Optional[torch.Tensor] = None,  # inject instead of sampling (tests)
    noise: Optional[torch.Tensor] = None,
    ts_state: Optional[tsample.LossSecondMomentState] = None,  # loss-aware sampler
) -> Tuple[Dict[str, float], Optional[tsample.LossSecondMomentState]]:
    """One step; returns the metrics (loss, mse, vb, grad_norm,
    skipped_nonfinite, loss_q0..q3 by timestep quartile) and the sampler's
    new state.  Train or eval mode is the model's own."""
    model = state.model
    x0 = batch["motion"]
    B, device = x0.shape[0], x0.device
    T = schedule.num_timesteps
    if t is None:
        if ts_state is not None:
            t, weights = tsample.loss_second_moment_sample(generator, ts_state, B)
        else:
            t, weights = tsample.uniform_sample(generator, T, B)
    else:
        weights = torch.ones((B,), dtype=torch.float32)
    t, weights = t.to(device), weights.to(device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=noise_generator, device=device)
    xt = gaussian.q_sample(schedule, x0, t, noise)

    # a face batch has no keyframes; a cached batch has features in place of audio
    out = model(xt, t, batch.get("audio"), batch.get("keyframes"), batch.get("keyframe_valid"),
                cond_drop_prob=dcfg.cond_drop_prob, generator=generator,
                audio_features=batch.get("audio_features"), lip_verts=batch.get("lip_verts"))
    terms = losses.training_losses(schedule, dcfg.predict, out, x0, xt, t, batch["mask"][..., None],
                                   lambda_vel=dcfg.lambda_vel, var_type=dcfg.var_type, with_vb=True,
                                   vel_mask=validity_mask(batch, x0.shape[1]))
    loss = (terms["loss"] * weights).mean()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()

    with torch.no_grad():
        grad_norm = global_norm(state.grads())
        per = terms["loss"].detach()
        quartile = (QUARTILES * t) // T  # loss by timestep bucket (training_loop.py:282-288)
        sel = (quartile[None] == torch.arange(QUARTILES, device=device)[:, None]).float()
        q_loss = (sel * per[None]).sum(-1) / torch.clamp(sel.sum(-1), min=1.0)
        host = torch.cat([torch.stack([loss.detach(), terms["mse"].mean(), terms["vb"].mean(), grad_norm]),
                          q_loss, sel.sum(-1)]).cpu().tolist()  # the step's one read-back
    loss_v, mse, vb, gnorm = host[:4]
    finite = math.isfinite(loss_v) and math.isfinite(gnorm)
    if finite:
        state.apply_gradients(gnorm)
    metrics = {"loss": loss_v, "mse": mse, "vb": vb, "grad_norm": gnorm, "skipped_nonfinite": float(not finite)}
    for q in range(QUARTILES):
        metrics[f"loss_q{q}"] = host[4 + q] if host[4 + QUARTILES + q] > 0 else math.nan
    if ts_state is not None:
        ts_state = tsample.loss_second_moment_update(ts_state, t.cpu(), per)
    return metrics, ts_state
