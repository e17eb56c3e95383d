"""Checkpoints of the train state, and the model files ``generate`` loads.

Counterpart of ``audio2photoreal_tpu/train/checkpoints.py`` (reference:
training_loop.py:89-107, 229-267): save every N steps under step-stamped
names, keep the newest few, resume from the latest with model, optimizer,
schedule, EMA and step.  A checkpoint is one ``torch.save`` file,
``<ckpt_dir>/step_<N>.pt``, written to a temporary name and renamed, so a
reader never sees half a file.

``save_model`` writes ``model.pt`` (the model's state_dict under the
reference's names) beside the run's ``config.json``: the directory is then a
checkpoint that ``apps/generate.py`` samples from as it is.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from audio2photoreal_tpu_torch.train.state import TrainState

MODEL_FILE = "model.pt"  # apps/generate.py:MODEL_FILE
_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def steps(ckpt_dir: str):
    """Saved steps, oldest first."""
    found = (_STEP_FILE.search(os.path.basename(p)) for p in glob.glob(os.path.join(ckpt_dir, "step_*.pt")))
    return sorted(int(m.group(1)) for m in found if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def save_train_state(ckpt_dir: str, step: int, state: TrainState, max_to_keep: int = 3,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``{step, model, optimizer, scheduler, ema}`` as step ``step``
    and drop all but the newest ``max_to_keep``.  ``extra`` rides along: a
    trainer's own state that the model's buffers do not hold (the VQ
    trainer's best validation loss)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    _atomic_save({**state.state_dict(), "extra": dict(extra or {})}, path)
    for old in steps(ckpt_dir)[:-max_to_keep]:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def try_resume(ckpt_dir: str, state: TrainState) -> Tuple[Optional[int], Dict[str, Any]]:
    """Load the latest checkpoint into ``state`` -> (its step, its
    ``extra``), or (None, {}) when there is none."""
    last = latest_step(ckpt_dir)
    if last is None:
        return None, {}
    device = next(state.model.parameters()).device
    path = checkpoint_path(ckpt_dir, last)
    sd = torch.load(path, map_location=device, weights_only=True)
    if "optimizer" not in sd:
        raise ValueError(f"{path} holds no optimizer state (a save dir converted from the JAX package carries "
                         "only its EMA): train into another directory")
    state.load_state_dict(sd)
    return last, sd.get("extra", {})


def save_model(save_dir: str, model: torch.nn.Module) -> str:
    """``<save_dir>/model.pt`` for ``apps/generate.py:load_model``."""
    path = os.path.join(save_dir, MODEL_FILE)
    _atomic_save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path
