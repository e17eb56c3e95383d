"""BENCHMARK.json against the benchmark's contract and its files."""

from __future__ import annotations

import importlib
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_names_units_and_text():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    for e in BENCH["configs"] + BENCH["workloads"] + METRICS:
        for k in TEXT_KEYS:
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves(workload):
    cell = harness.Cell.named(workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"].startswith("portbench/configs/") and cell.config["name"] == config["name"]
    assert cell.config["reduced"] == config["reduced"] == []
    importlib.import_module("portbench.loads." + cell.traffic["kind"])
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_resolves(metric):
    assert callable(harness.reader(metric))


def test_per_layer_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", WORKLOADS))
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert "kernels" in layers and any("mfu" in n for n in layers["denoiser"])


@pytest.mark.parametrize("held", sorted(os.listdir(os.path.join(harness.HERE, "held"))))
def test_held_back_cell_keeps_to_the_contract(held):
    entry = harness.load_json(os.path.join(harness.HERE, "held", held))
    assert set(entry) == {"why", "workloads", "end_to_end", "per_layer"} and len(entry["why"]) <= 200
    (w,) = entry["workloads"]
    assert held == w["name"] + ".json" and w["name"] not in WORKLOADS
    merged = harness.with_held(BENCH)
    cell = harness.Cell.named(w["name"], merged)
    assert cell.limits and {m["name"] for m in cell.end_to_end} >= {"setup_s"} and cell.per_layer
    names = [m["name"] for m in entry["end_to_end"] + entry["per_layer"]]
    assert not set(names) & {m["name"] for m in METRICS} and all(NAME.match(n) for n in names)
    for m in entry["per_layer"]:
        assert set(m["workloads"]) == {w["name"]} and callable(harness.reader(m["name"]))


def test_every_config_has_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
