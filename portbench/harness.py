"""What every cell's run shares: the benchmark file, the cell's files, the
spans, the profiled window and its reduction, the metric readers, the
result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the traffic's ``kind`` names the load
(``loads/<kind>.py``) that generates its load.  A metric is read by
``metrics/<metric name>.py``'s ``read(run)``, which returns a number or
None when the run has nothing for it to read.  The check's limits are in
``limits/<cell>.json``.  All of them are found by the names in
``BENCHMARK.json``, so a new cell or metric adds files and edits none.
A cell held back from ``BENCHMARK.json`` keeps its entries in
``held/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "audio2photoreal_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def with_held(bench: dict) -> dict:
    """``bench`` with the cells held back from it (``held/<cell>.json``:
    their ``workloads``, ``end_to_end`` and ``per_layer`` entries), which
    the tests and ``control.py`` can still build; the benchmark's runs take
    ``BENCHMARK.json``'s cells alone."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    folder = os.path.join(HERE, "held")
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
        held = load_json(os.path.join(folder, name))
        for key in ("workloads", "end_to_end", "per_layer"):
            out[key] += held[key]
    return out


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def named(cls, name: str, bench: Optional[dict] = None) -> "Cell":
        bench = bench or benchmark()
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; one of {sorted(by_name)}")
        w = by_name[name]
        cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
        reports = lambda m: name in m.get("workloads", [name])  # noqa: E731
        e2e = [m for m in bench["end_to_end"] if reports(m)]
        e2e_names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names and reports(m)]
        return cls(name, w["chips"], load_json(os.path.join(ROOT, cfg["file"])),
                   load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
                   load_json(os.path.join(HERE, "limits", name + ".json")), e2e, layer)


@dataclass
class Run:
    """What a load hands back: the numbers its window measured, what the
    metric readers read, and the check."""

    seconds: float  # the measured window's wall
    setup_s: float
    attempted: int
    failed: int
    work: Dict[str, float] = field(default_factory=dict)  # counts of the window: steps, samples, audio seconds, ...
    spans: Dict[str, float] = field(default_factory=dict)  # host-clock seconds by span name, summed over the window
    flops: Dict[str, float] = field(default_factory=dict)  # model FLOPs of the window by part
    attention: List[Tuple[str, dict, int]] = field(default_factory=list)  # (fwd|bwd, shape, launches) of the window
    dtype: str = "float32"
    trace: Optional["TraceSummary"] = None
    checks: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, value, limit)
    device: Dict[str, object] = field(default_factory=dict)


class Spans:
    """Host-clock spans around the calls into each layer, in a traced run
    only: their seconds summed by name, and each one's interval on the
    clock the profiler stamps the device's operations with (Unix time in
    ns), so the trace's reduction can place every device operation in the
    span the host was in.  With ``sync`` the device is synchronised at both
    ends, so the span holds the layer's device work."""

    def __init__(self, traced: bool, sync):
        self.traced, self.sync = traced, sync
        self.total: Dict[str, float] = {}
        self.ranges: List[Tuple[int, int, str]] = []

    def clear(self) -> None:
        self.total.clear()
        self.ranges.clear()

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = True):
        if not self.traced:
            yield
            return
        if sync:
            self.sync()
        t0 = time.time_ns()
        yield
        if sync:
            self.sync()
        t1 = time.time_ns()
        self.ranges.append((t0, t1, name))
        self.total[name] = self.total.get(name, 0.0) + (t1 - t0) / 1e9


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler recording the device's operations over the block when
    ``enabled`` (not the host's: recording every host op would slow the
    launches it measures); yields the profile or None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]) as prof:
        yield prof


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, device seconds)
    launches_in: Dict[str, int]  # span name -> kernel launches that started inside it
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, t, outside: str = "none"):
    """The name of the shortest span that holds time ``t``, or ``outside``."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return outside if best is None else best[2]


def reduce_trace(prof, spans: List[Tuple[int, int, str]], window_span: str = "window",
                 top: int = 10) -> TraceSummary:
    """The device's operations inside the host's ``window`` span: their
    busy time (the union of their intervals), launches and time by kernel
    name, the launches that started inside each other span, and the
    longest idle gaps named by the innermost span the host was in."""
    import bisect

    from torch.autograd import DeviceType

    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    win = [(s, e) for s, e, n in spans if n == window_span]
    if not win:
        raise RuntimeError(f"no {window_span} span was recorded")
    w0, w1 = win[0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    if device and len(inside) < len(device) // 2:
        raise RuntimeError(f"{len(inside)} of the trace's {len(device)} device operations fall in the host's "
                           "window: the profiler's clock is not the host's")
    merged = _merge([(s, e) for s, e, _ in inside])
    kernels: Dict[str, List[float]] = {}
    for s, e, n in inside:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
    inner = [(s, e, n) for s, e, n in spans if n != window_span]
    starts = sorted(s for s, _, n in inside if not n.startswith(("Memcpy", "Memset")))
    launches_in: Dict[str, int] = {}
    for s, e, n in inner:
        launches_in[n] = launches_in.get(n, 0) + bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])
    named_gaps = [[_innermost(inner, (s + e) / 2, window_span), (e - s) / 1e9] for s, e in gaps[:top]]
    ops = sorted(([n[:160], v[1]] for n, v in kernels.items()), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=sum(e - s for s, e in merged) / 1e9,
                        kernels={n: (v[0], v[1]) for n, v in kernels.items()}, launches_in=launches_in,
                        device_ops=ops, idle_gaps=named_gaps)


def peaks() -> dict:
    return load_json(os.path.join(HERE, "peaks.json"))


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(specs: List[dict], run: Run) -> Dict[str, dict]:
    out = {}
    for m in specs:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def result_line(cell: Cell, run: Run, trace: bool) -> dict:
    specs = cell.per_layer if trace else cell.end_to_end
    correct = all(v <= limit for _, v, limit in run.checks) and bool(run.checks)
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": read_metrics(specs, run), "device": dict(run.device)}
    if trace and run.trace is not None:
        line["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    line["checked"] = {name: {"value": v, "limit": limit} for name, v, limit in run.checks}
    return line
