"""Shares of the card's peak, read from a run.

A kernel's roofline share: the least time the card could take for the
window's launches of that kernel (per launch the larger of its FLOPs over
the peak of the run's compute dtype and its bytes over the memory
bandwidth, ``counters/attention.py``), over the device time of the kernels
whose names hold ``pattern`` in the trace.  A model's share of the peak:
the window's model FLOPs over its wall and the peak.
"""

from __future__ import annotations

from typing import Optional

from portbench import harness
from portbench.counters import attention


def kernel_share(run: harness.Run, kind: str, pattern: str) -> Optional[float]:
    if run.trace is None:
        return None
    device_s = sum(sec for name, (_, sec) in run.trace.kernels.items() if pattern in name)
    shapes = [(s, n) for k, s, n in run.attention if k == kind]
    if device_s <= 0.0 or not shapes:
        return None
    pk = harness.peaks()
    flops, bw = pk["flops_per_s"][run.dtype], pk["hbm_bytes_per_s"]
    least = sum(n * max(attention.kernel_flops(kind, s) / flops, attention.kernel_bytes(kind, s, run.dtype) / bw)
                for s, n in shapes)
    return 100.0 * least / device_s


def model_share(run: harness.Run, part: Optional[str] = None) -> Optional[float]:
    flops = run.flops.get(part, 0.0) if part else sum(run.flops.values())
    if flops <= 0.0 or run.seconds <= 0.0:
        return None
    return 100.0 * flops / run.seconds / harness.peaks()["flops_per_s"][run.dtype]
