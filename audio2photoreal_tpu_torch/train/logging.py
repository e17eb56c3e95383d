"""Training log: a stdout line and ``log.jsonl`` per logged step.

Counterpart of ``audio2photoreal_tpu/train/logging.py`` (``KVLogger`` with
its JSONL sidecar; reference utils/logger.py), and of the reference's
``TrainPlatform`` strategy (train/train_platforms.py) with ``NoPlatform``
only: TensorBoard and ClearML are not ported and raise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class KVLogger:
    """``log(step, metrics)``: one stdout line and one ``log.jsonl`` row."""

    def __init__(self, save_dir: Optional[str] = None):
        self._jsonl = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._jsonl = open(os.path.join(save_dir, "log.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        kv = {k: float(v) for k, v in metrics.items()}
        print(f"[step {step}] " + " | ".join(f"{k} {v:.4g}" for k, v in kv.items()), flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(), **kv}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


class TrainPlatform:
    """report_scalar / report_args / close (train_platforms.py:10-24)."""

    def __init__(self, save_dir: Optional[str] = None):
        self.save_dir = save_dir

    def report_scalar(self, name: str, value: float, iteration: int, group_name: str = "") -> None:
        pass

    def report_args(self, args, name: str = "args") -> None:
        pass

    def close(self) -> None:
        pass


class NoPlatform(TrainPlatform):
    """train_platforms.py:51-56."""


PLATFORMS = ("NoPlatform", "TensorboardPlatform", "ClearmlPlatform")


def create_platform(name: str, save_dir: Optional[str]) -> TrainPlatform:
    """``--train_platform_type``: NoPlatform; the others are not ported."""
    if name == "NoPlatform":
        return NoPlatform(save_dir)
    if name in PLATFORMS:
        raise NotImplementedError(f"{name} is not ported yet: see ROADMAP")
    raise ValueError(f"unknown train platform {name!r}; options: {list(PLATFORMS)}")
