"""Tracing and timing.

Counterpart of ``audio2photoreal_tpu/utils/profiling.py`` (reference: the
cProfile of the first steps, ``Timer`` and ``profile_kv`` of
train/training_loop.py:136-162, utils/misc.py:197-223):

- ``profile_trace``: ``torch.profiler`` over a block, the host and (on a
  card) the device, written as a chrome trace into the directory;
- ``Timer``: steps per second as an exponential moving average.

The JAX package's ``aot_compile`` lowers and compiles a jitted function
ahead of its first call; an eager program has nothing to compile ahead, so
it has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``with profile_trace(dir): step(...)`` -> ``dir/trace.json``; yields
    the profiler (its ``key_averages()`` summarise the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Steps per second with an EMA (utils/misc.py:197-223)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rate: Optional[float] = None
        self._last = time.time()

    def tick(self, n: int = 1) -> float:
        now = time.time()
        dt = max(now - self._last, 1e-9)
        self._last = now
        inst = n / dt
        self.rate = inst if self.rate is None else self.ema * self.rate + (1 - self.ema) * inst
        return self.rate
