"""The result line and the trace's reduction, on made-up runs."""

from __future__ import annotations

import pytest

from portbench import harness


def _run(trace: bool) -> harness.Run:
    run = harness.Run(seconds=10.0, setup_s=30.0, attempted=5, failed=0, dtype="float32")
    run.work = {"calls": 2, "audio_s": 640.0, "ddim_steps": 1000, "samples": 320, "step_s": 10.0,
                "batch_wait_s": 1.0}
    run.spans = {"keyframer": 1.0, "encode": 0.5, "ddim": 8.0}
    run.flops = {"ddim": 2e14}
    run.device = {"memory_peak_bytes": 123, "platform": "gpu", "kind": "x", "count": 1}
    run.checks = [("denoiser", 1e-7, 1e-5)]
    if trace:
        run.trace = harness.TraceSummary(window_s=10.0, busy_s=8.0, kernels={"void attn_fwd_kernel<64>": (4, 0.5)},
                                         launches_in={"ddim": 300_000}, device_ops=[["k", 1.0]],
                                         idle_gaps=[["ddim", 0.01]])
    run.attention = [("fwd", {"B": 32, "H": 4, "Tq": 600, "Tk": 2000, "Dh": 64}, 4)]
    return run


@pytest.mark.parametrize("workload,trace", [(w, t) for w in ("pose.sample", "face.sample", "face.train")
                                           for t in (False, True)])
def test_result_line_keys(workload, trace):
    cell = harness.Cell.named(workload, harness.with_held(harness.benchmark()))
    line = harness.result_line(cell, _run(trace), trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checked"  # the compared numbers beside their limits come last
    assert set(keys) == {"correct", "attempted", "failed", "metrics", "device", "checked"} | (
        {"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] == 8.0 and line["device"]["window_s"] == 10.0
    specs = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in specs}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}


def test_correct_needs_every_number_within_its_limit():
    cell = harness.Cell.named("pose.sample")
    run = _run(False)
    assert harness.result_line(cell, run, False)["correct"]
    run.checks.append(("ddim_update", 2e-5, 1e-5))
    assert not harness.result_line(cell, run, False)["correct"]
    run.checks = [("ddim_update", float("nan"), 1e-5)]
    assert not harness.result_line(cell, run, False)["correct"]
    run.checks = []
    assert not harness.result_line(cell, run, False)["correct"]


def test_shares_stay_under_100():
    cell = harness.Cell.named("pose.sample")
    metrics = harness.result_line(cell, _run(True), True)["metrics"]
    for name, v in metrics.items():
        if v["unit"] == "%":
            assert 0.0 <= v["value"] <= 100.0, name


def test_trace_reduction_merges_and_names_gaps():
    assert harness._merge([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    spans = [(0, 100, "window"), (10, 40, "ddim"), (50, 90, "encode")]
    assert harness._innermost(spans, 20) == "ddim" and harness._innermost(spans, 45) == "window"
    assert harness._innermost(spans[1:], 45, "window") == "window"
