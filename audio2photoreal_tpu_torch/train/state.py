"""Train state: model, AdamW, learning-rate schedule, EMA and step.

Counterpart of ``audio2photoreal_tpu/train/state.py``: AdamW with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8) and the configured weight decay, the
reference's linear anneal or a linear warmup (training_loop.py:217-222),
optional global-norm clipping as optax's ``clip_by_global_norm`` clips, and
an EMA of the parameters.  Parameters that do not require a gradient (the
frozen wav2vec frontend) are left out of the optimizer, as the JAX package
masks its frozen frontends out of optax.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from audio2photoreal_tpu_torch.core.config import TrainConfig

def trainable_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates: those that require a gradient
    (the reference never optimises its frozen frontends, model/utils.py:18-26)."""
    return [p for p in model.parameters() if p.requires_grad]


def lr_factor(cfg: TrainConfig, step: int) -> float:
    """optax.linear_schedule as the JAX package builds it, over the base lr."""
    if cfg.lr_anneal_steps:
        return 1.0 - min(step, cfg.lr_anneal_steps) / cfg.lr_anneal_steps
    if cfg.warmup_steps:
        return min(step, cfg.warmup_steps) / cfg.warmup_steps
    return 1.0


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).  On
    the card ``_foreach_norm`` reduces by trees; the CPU's norm kernel sums
    in f32 lanes, 1e-4 off at a few million elements, so there each
    tensor's squares go through ``sum``'s cascade."""
    tensors = list(tensors)
    if tensors[0].device.type == "cpu":
        return torch.stack([(t * t).sum() for t in tensors]).sum().sqrt()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainState:
    """What a step updates and a checkpoint keeps.  ``step`` counts applied
    updates: a step skipped by the non-finite guard leaves it, the optimizer
    and the schedule as they were."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig):
        self.model, self.cfg = model, cfg
        self.params = trainable_parameters(model)
        self.optimizer = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lambda s: lr_factor(cfg, s))
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if cfg.ema_decay > 0:
            self.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.step = 0

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def apply_gradients(self, grad_norm: float) -> None:
        """Clip (when configured), one AdamW update, the schedule, the EMA.
        ``grad_norm`` is the global norm of the gradients, already read."""
        if self.cfg.grad_clip > 0 and not grad_norm < self.cfg.grad_clip:
            for p in self.params:
                if p.grad is not None:
                    p.grad.div_(grad_norm).mul_(self.cfg.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        if self.ema is not None:
            d = self.cfg.ema_decay
            for n, p in self.model.named_parameters():
                self.ema[n].mul_(d).add_(p, alpha=1.0 - d)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "ema": self.ema}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        if sd.get("ema") is not None:
            device = next(self.model.parameters()).device
            self.ema = {n: t.to(device) for n, t in sd["ema"].items()}
        self.step = int(sd["step"])
