"""The check's control and faults, read at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n,n,...> [--precision tf32|bf16|fp8]
                                 [--fault half_batch|altered_token] [--program] [--out <file.jsonl>]

For each seed it prints one JSON line with the numbers the cell's check
compares, read with the program's place taken by:

- the reference computed in ``--precision`` (the control: by default the
  nearest precision below the cell's, tf32 for an f32 cell, fp8 for a
  bf16 one), against the reference in f32;
- with ``--fault half_batch`` (training cells), the reference whose loss is
  the mean over the first half of the batch;
- with ``--fault altered_token`` (cells with a guide), the program with
  the first clip's token at every guide step replaced by its least likely
  one, where the token is produced;
- with ``--program``, the program itself: the numbers a run's check
  compares, from the set-up's checked steps (training) or one window call
  (sampling), seed after seed in one process.

A training cell's control needs no program run: it trains from the same
weights and batches.  A sampling cell runs the program for one call (its
DDIM states are what the check steps from), then the control steps from
the same states.  The benchmark's own runs never run this; its limits in
``limits/<cell>.json`` sit between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BELOW = {"float32": "tf32", "bfloat16": "fp8"}


def train_readings(cell, seed: int, dev, precision: str, fault: str = "") -> dict:
    from portbench import inputs
    from portbench.loads import train

    tr = cell.traffic
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        root = os.path.join(work, "data")
        pc = tr["person"]
        inputs.write_person(root, seed, pc["train_scenes"], pc["held_out_scenes"], pc["frames_per_scene"])
        run_seed = inputs.sub_seed(seed, 2) % 2**31
        want = train.reference_steps(cell, root, seed, run_seed, dev)
        if fault == "half_batch":
            got = train.reference_steps(cell, root, seed, run_seed, dev, drop_half=True)
        else:
            got = train.reference_steps(cell, root, seed, run_seed, dev, precision=precision)
        return train.numbers(got["loss"], got["grad"], got["change"], want)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _least_likely_first_clip(real):
    def altered(logits, top_p, gumbel):
        out = real(logits, top_p, gumbel).clone()
        out[0] = logits[0].argmin()
        return out

    return altered


def sample_readings(cell, seed: int, dev, precision: str, fault: str = "") -> dict:
    from audio2photoreal_tpu_torch.models import guide as guide_mod
    from portbench.loads import sample

    records = []
    real_check, real_sample = sample.check, guide_mod.nucleus_sample
    sample.check = lambda cell_, seed_, recs, dev_: records.extend(recs) or []
    if fault == "altered_token":
        guide_mod.nucleus_sample = _least_likely_first_clip(real_sample)
    try:
        sample.run(cell, seed, 0.0, False, dev, time.perf_counter())
    finally:
        sample.check, guide_mod.nucleus_sample = real_check, real_sample
    if fault:
        return sample.numbers(cell, seed, records, dev)
    models = sample.reference_models(cell, seed, dev)
    want = sample.reference_outputs(cell, seed, records, dev, models)
    got = sample.reference_outputs(cell, seed, records, dev, models, precision)
    out = sample.compare(got, want)
    out.update(sample.tokens_outside(cell, records, [g["guide_logits"] for g in got if "guide_logits" in g]))
    return out


def program_readings(cell, seed: int, dev) -> dict:
    import importlib

    load = importlib.import_module("portbench.loads." + cell.traffic["kind"])
    return {name: v for name, v, _ in load.run(cell, seed, 0.0, False, dev, time.perf_counter()).checks}


def readings(cell, seed: int, dev, precision: str = "", fault: str = "", program: bool = False) -> dict:
    if program:
        return program_readings(cell, seed, dev)
    precision = precision or BELOW[cell.traffic["point"]["denoiser"]["dtype"]]
    if cell.traffic["kind"] == "train":
        return train_readings(cell, seed, dev, precision, fault)
    return sample_readings(cell, seed, dev, precision, fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--precision", default="", choices=["", "tf32", "bf16", "fp8"])
    p.add_argument("--fault", default="", choices=["", "half_batch", "altered_token"])
    p.add_argument("--program", action="store_true", help="read the program's own numbers")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Cell.named(args.workload, harness.with_held(harness.benchmark()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, dev, args.precision, args.fault, args.program)
        side = "program" if args.program else args.precision or "below"
        line = json.dumps({"workload": args.workload, "seed": seed, "precision": side,
                           "fault": args.fault, "numbers": got, "limits": cell.limits,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
