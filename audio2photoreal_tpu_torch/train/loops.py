"""The train steps of the diffusion denoiser, the VQ codec, the guide LM and
the codec avatar.

Counterpart of ``audio2photoreal_tpu/train/loops.py``.  The diffusion step
(``make_diffusion_train_step``; reference: training_loop.py:174-215 +
gaussian_diffusion.py:1195-1271): sample t and noise, diffuse, run the
training forward (pose or face, on raw audio or on the feature cache's
``audio_features`` / ``lip_verts``), masked L2 (+ velocity, masked by the
batch's lengths, + the vb diagnostic), backward, and one optimizer update
unless the loss or the gradient norm is not finite, in which case the
update is skipped (the role of the reference's fp16 NaN backoff).  The VQ
step (``make_vq_train_step``; train_vq.py:127-155): SmoothL1 reconstruction
of the 1 fps keyframes + commitment + velocity, the codebooks updated in
the forward.  The guide step (``make_guide_train_step``;
train_guide.py:71-107): keyframes tokenised by the frozen codec, shifted
right behind the start token, label-smoothed cross-entropy over the valid
keyframes' tokens.  The VQ and guide steps update always, as the JAX
package's do.  The avatar step (``avatar_train_step``; JAX
train/loops.py:190-283): the BodyAvatar's training forward, masked L1 on
the render + vertex L2 + KL + shadow distillation + the blur regulariser,
skipped when not finite as the diffusion step is.

Every random draw of a step comes from generators the caller seeds for that
step: a CPU one (t, the guidance-dropout draws, one seed per dropout site)
and one on the model's device (the diffusion noise; the VQ's k-means and
dead-code rows; the avatar's posterior noise).  Each step reads its metrics back to the host once.
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
LABEL_SMOOTHING = 0.1  # train_guide.py:50-52
GUIDE_COND_DROP = 0.2  # the JAX guide step's default


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


def _update(state: TrainState, loss: torch.Tensor, extra: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Backward, the gradients' global norm, one read-back of the metrics,
    one optimizer update -> the metrics."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        names = ["loss", *extra, "grad_norm"]
        values = torch.stack([loss.detach(), *(v.detach() for v in extra.values()), global_norm(state.grads())])
        metrics = dict(zip(names, values.float().cpu().tolist()))  # the step's one read-back
    state.apply_gradients(metrics["grad_norm"])
    return metrics


def huber(a: torch.Tensor, b: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """SmoothL1, the mean over every element (train_vq.py's loss)."""
    d = (a - b).abs()
    return torch.where(d < delta, 0.5 * d**2 / delta, d - 0.5 * delta).mean()


def vq_train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                  commit_weight: float = 0.02, lambda_vel: float = 1.0) -> Dict[str, float]:
    """One codec step on ``batch["keyframes"]`` [B, K, nfeats] -> metrics
    (loss, recon, commit, perplexity, grad_norm).  The codebooks' k-means
    init, expiry and EMA happen in the forward, their draws from
    ``generator`` (on the model's device)."""
    motion = batch["keyframes"]
    out = state.model(motion, train=True, generator=generator)
    recon = huber(out.recon, motion)
    vel = huber(out.recon[:, 1:] - out.recon[:, :-1], motion[:, 1:] - motion[:, :-1])
    loss = recon + commit_weight * out.commit_loss + lambda_vel * vel
    return _update(state, loss, {"recon": recon, "commit": out.commit_loss, "perplexity": out.perplexity})


def guide_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
               label_smoothing: float = LABEL_SMOOTHING) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (label-smoothed cross-entropy, token accuracy), each summed over
    the valid tokens and divided by their count (at least 1).  logits [B,
    L, V], targets [B, L], valid [B, L]."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    # label smoothing (train_guide.py:50-52): (1 - eps) CE + eps uniform-CE
    ce = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(dim=-1)
    count = torch.clamp(valid.sum(), min=1.0)
    acc = ((logits.argmax(-1) == targets).to(valid.dtype) * valid).sum() / count
    return (ce * valid).sum() / count, acc


def guide_train_step(state: TrainState, codec, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None, cond_drop_prob: float = GUIDE_COND_DROP,
                     *, keep_mask: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """One guide-LM step -> metrics (loss, acc, grad_norm).  ``codec`` is
    the frozen VQ (eval mode) that tokenises ``batch["keyframes"]``; the
    conditioning is raw ``audio`` or cached ``audio_features``; ``generator``
    (CPU) draws the conditioning dropout, unless ``keep_mask`` is given, and
    the dropout sites' seeds."""
    model = state.model
    keyframes = batch["keyframes"]
    B, depth = keyframes.shape[0], codec.cfg.depth
    with torch.no_grad():
        targets = codec.encode(keyframes).reshape(B, -1)  # flatten time-major (train_guide.py:84-88)
    start = torch.full((B, 1), model.start_token, dtype=targets.dtype, device=targets.device)
    inputs = torch.cat([start, targets[:, :-1]], dim=1)
    valid = batch["keyframe_valid"].repeat_interleave(depth, dim=-1)  # [B, K * depth]
    logits = model(inputs, batch.get("audio"), cond_drop_prob, generator,
                   audio_features=batch.get("audio_features"), keep_mask=keep_mask)
    loss, acc = guide_loss(logits, targets, valid)
    return _update(state, loss, {"acc": acc})


def _kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, σ²) ‖ N(0, 1)) with σ = exp(logvar), the mean over elements
    (the posterior sample is mu + exp(logvar)·ε)."""
    return 0.5 * (torch.exp(2 * logvar) + mu**2 - 1.0 - 2 * logvar).mean()


def avatar_train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                      kl_weight: float = 1e-3, geom_weight: float = 1.0, shadow_weight: float = 0.1,
                      blur_reg_weight: float = 1e-3) -> Dict[str, float]:
    """One BodyAvatar step (the JAX package's ``make_avatar_train_step``,
    train/loops.py:190-283) -> metrics (loss, grad_norm, loss_rgb,
    loss_geom, loss_kl, loss_shadow, loss_blur_reg, skipped_nonfinite).

    The training forward (``BodyAvatar.train_forward``) with both posteriors
    sampled from ``generator`` (on the model's device); the loss is the L1
    of the linear render against ``image`` under ``image_mask`` (or, without
    one, the raster's coverage), summed and divided by max(mask sum, 1)·3,
    + the vertices' L2 + both posteriors' KL + the pose shadow's L2 to the
    detached GT-AO shadow + LearnableBlur's regulariser.  A non-finite loss
    or gradient norm leaves the state as it was.

    batch: motion [B, 104], geom [B, V, 3], face_embs [B, Nf], ao [B, 1,
    S, S], campos [B, 3], K [B, 3, 3], Rt [B, 3, 4], image [B, H, W, 3],
    image_mask [B, H, W, 1] (optional), cam_idx [B] int."""
    model = state.model
    preds = model(batch["motion"], batch["campos"], geom=batch["geom"], face_embs=batch["face_embs"], K=batch["K"],
                  Rt=batch["Rt"], ao=batch["ao"], cam_idx=batch["cam_idx"], training=True, posterior_noise=True,
                  generator=generator)
    mask = batch.get("image_mask")
    if mask is None:
        mask = (preds["pix_to_face"] >= 0)[..., None].float()
    l_rgb = ((preds["rgb"] - batch["image"]).abs() * mask).sum() / torch.clamp(mask.sum(), min=1.0) / 3.0
    l_geom = ((preds["geom"] - batch["geom"]) ** 2).mean()
    l_kl = _kl(preds["embs_mu"], preds["embs_logvar"]) + _kl(preds["face_embs_mu"], preds["face_embs_logvar"])
    l_shadow = ((preds["pose_shadow_map"] - preds["shadow_map"].detach()) ** 2).mean()
    l_blur = model.learn_blur.reg(batch["cam_idx"])
    loss = l_rgb + geom_weight * l_geom + kl_weight * l_kl + shadow_weight * l_shadow + blur_reg_weight * l_blur
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        parts = {"loss_rgb": l_rgb, "loss_geom": l_geom, "loss_kl": l_kl, "loss_shadow": l_shadow,
                 "loss_blur_reg": l_blur}
        values = torch.stack([loss.detach(), global_norm(state.grads()), *(v.detach() for v in parts.values())])
        metrics = dict(zip(["loss", "grad_norm", *parts], values.cpu().tolist()))  # the step's one read-back
    finite = math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"])
    if finite:
        state.apply_gradients(metrics["grad_norm"])
    metrics["skipped_nonfinite"] = float(not finite)
    return metrics
