"""A run of each cell's load loads neither JAX nor the JAX package.

Run in a fresh interpreter: the repository's own test suite imports JAX in
the same process, and its modules would be counted here."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.tinycells import tiny
import importlib
cell = tiny({workload!r})
importlib.import_module("portbench.loads." + cell.traffic["kind"]).run(cell, 5, 0.0, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_load_imports_no_jax(workload):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=harness.ROOT, workload=workload)],
                         capture_output=True, text=True, timeout=600, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "audio2photoreal_tpu_torch" in top and not top & set(harness.FORBIDDEN_MODULES), top & set(
        harness.FORBIDDEN_MODULES)


def test_forbidden_names_compare_whole():
    import audio2photoreal_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "audio2photoreal_tpu_torch" not in harness.forbidden_modules()
    assert set(harness.forbidden_modules()) <= set(harness.FORBIDDEN_MODULES)


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    from portbench import run

    assert run.main(["--workload", "face.sample", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
