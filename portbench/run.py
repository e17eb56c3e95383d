"""The benchmark of audio2photoreal_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the traffic's load
(``loads/<kind>.py``) makes the inputs and weights from the seed, sets
up, warms the cell's shapes up, measures for ``--seconds``, and checks what
the timed path produced against the plain reference (``reference/``).
With ``--trace 0`` the last line of standard output is the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled window.  The compared numbers, each beside its limit, are the
last lines of standard error and the last key of the result line.

Exits non-zero without printing a result when there is no CUDA device or
fewer than the cell asks for, or when the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")  # a library that could load flax is kept from it


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.Cell.named(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    tf32 = cell.traffic["point"]["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    load = importlib.import_module("portbench.loads." + cell.traffic["kind"])
    run = load.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    run.device.update(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips)
    line = harness.result_line(cell, run, bool(args.trace))
    for name, v, limit in run.checks:
        print(f"check {name}: {v!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
