"""The cells' loads on the card at a small size: the kernels' path, the
check, the trace's reduction.  Marked ``cuda``; skip without a card.

    python -m pytest --noconftest -m cuda portbench/tests -q
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests.tinycells import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_tiny_cell_on_the_card(workload, card):
    import importlib

    cell = tiny(workload, head_dim=64, frames=150)  # the kernels take Dh 64 and 128
    load = importlib.import_module("portbench.loads." + cell.traffic["kind"])
    run = load.run(cell, 2**40 + 3, 1.0, True, card, time.perf_counter())
    line = harness.result_line(cell, run, True)
    assert line["correct"], line["checked"]
    flash = cell.traffic["point"]["denoiser"].get("flash_attention", cell.config["denoiser"]["flash_attention"])
    assert run.trace.busy_s > 0 and any("attn_fwd" in k for k in run.trace.kernels) == flash
    assert all(0 <= v["value"] <= 100 for v in line["metrics"].values() if v["unit"] == "%"), line["metrics"]
