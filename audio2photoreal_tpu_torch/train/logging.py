"""Training log: a stdout line, ``log.jsonl`` and optionally TensorBoard.

Counterpart of ``audio2photoreal_tpu/train/logging.py`` (reference:
utils/logger.py:28-474, the OpenAI-baselines kv-logger, and
train/train_platforms.py:10-56, the ``TrainPlatform`` strategy):
``logkv_mean`` / ``dump`` / ``log`` with stdout, JSONL and TensorBoard
writers, ``profile_kv`` for wall time per named scope, and the three
platforms.  TensorBoard writes through ``torch.utils.tensorboard``; where
its ``SummaryWriter`` cannot be made the logger runs without it, as the JAX
package's does.  ``ClearmlPlatform`` imports ``clearml`` in its
constructor, so choosing it without the SDK raises there and nothing else
depends on it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class KVLogger:
    """``log(step, metrics)``: one stdout line, one ``log.jsonl`` row and,
    with ``tensorboard``, one scalar each; ``logkv_mean`` accumulates means
    that the next ``dump`` writes."""

    def __init__(self, save_dir: Optional[str] = None, tensorboard: bool = False):
        self._jsonl = None
        self._tb = None
        self._means = defaultdict(lambda: [0.0, 0])
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._jsonl = open(os.path.join(save_dir, "log.jsonl"), "a")
        if tensorboard and save_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(save_dir)
            except Exception:  # no tensorboard package: log without it
                self._tb = None

    def logkv_mean(self, key: str, value: float) -> None:
        s = self._means[key]
        s[0] += float(value)
        s[1] += 1

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.logkv_mean(k, v)
        self.dump(step)

    def dump(self, step: int) -> None:
        kv = {k: s[0] / max(s[1], 1) for k, s in self._means.items()}
        self._means.clear()
        print(f"[step {step}] " + " | ".join(f"{k} {v:.4g}" for k, v in kv.items()), flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(), **kv}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in kv.items():
                self._tb.add_scalar(k, v, step)

    @contextmanager
    def profile_kv(self, name: str):
        """Wall time of the scope, as the mean ``wall_<name>`` (utils/logger.py:296-325)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.logkv_mean(f"wall_{name}", time.time() - t0)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None


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


class TensorboardPlatform(TrainPlatform):
    """train_platforms.py:36-49, on ``KVLogger``'s TensorBoard and JSONL
    writers; ``report_args`` writes ``<name>.json``."""

    def __init__(self, save_dir: str):
        super().__init__(save_dir)
        self._logger = KVLogger(save_dir, tensorboard=True)

    def report_scalar(self, name: str, value: float, iteration: int, group_name: str = "") -> None:
        self._logger.log(iteration, {f"{group_name}/{name}" if group_name else name: float(value)})

    def report_args(self, args, name: str = "args") -> None:
        if self.save_dir:
            payload = dataclasses.asdict(args) if dataclasses.is_dataclass(args) else vars(args)
            with open(os.path.join(self.save_dir, f"{name}.json"), "w") as f:
                json.dump(payload, f, indent=1, default=str)

    def close(self) -> None:
        self._logger.close()


class ClearmlPlatform(TrainPlatform):
    """train_platforms.py:24-40: ``clearml`` is imported here, so this
    raises without the SDK."""

    def __init__(self, save_dir: str):
        if save_dir is None:
            raise ValueError("ClearmlPlatform requires save_dir")
        from clearml import Task

        super().__init__(save_dir)
        path, name = os.path.split(save_dir)
        self.task = Task.init(project_name="motion_diffusion", task_name=name, output_uri=path)
        self.logger = self.task.get_logger()

    def report_scalar(self, name: str, value: float, iteration: int, group_name: str = "") -> None:
        self.logger.report_scalar(title=group_name, series=name, iteration=iteration, value=value)

    def report_args(self, args, name: str = "args") -> None:
        self.task.connect(args, name=name)

    def close(self) -> None:
        self.task.close()


PLATFORMS = {"NoPlatform": NoPlatform, "TensorboardPlatform": TensorboardPlatform,
             "ClearmlPlatform": ClearmlPlatform}


def create_platform(name: str, save_dir: Optional[str]) -> TrainPlatform:
    """``--train_platform_type`` (utils/diff_parser_utils.py:182-187)."""
    if name not in PLATFORMS:
        raise ValueError(f"unknown train platform {name!r}; options: {sorted(PLATFORMS)}")
    return PLATFORMS[name](save_dir)
