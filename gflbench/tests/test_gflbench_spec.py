"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration and metric found by its name."""
import importlib
import json
import re

import pytest

from conftest import ROOT
from gflbench.harness import Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "gflbench/run.py"]
    assert SPEC["paths"] == ["gflbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("gflbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == []
        assert c["source"].startswith("https://")
        assert 1 <= len(c["why"]) <= 200


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)) and len(CELLS) == len(set(CELLS))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
        if kind == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in E2E and 1 <= len(m["layer"]) <= 200
            moved = next(e for e in SPEC["end_to_end"]
                         if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    bench = Bench(ROOT)
    e2e = [m["name"] for m in bench.metrics(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics(cell, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    bench = Bench(ROOT)
    wl = bench.workload(cell)
    assert hasattr(importlib.import_module(
        f"gflbench.drivers.{wl['driver']}"), "Driver")
    assert bench.config(bench.cell(cell)["config"])
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(Bench(ROOT).reader(metric))


def test_a_cell_added_by_new_files_is_listed(tiny_root):
    bench = Bench(tiny_root)
    assert {"tiny-sec5", "tiny-lm"} <= set(bench.cells())
    assert bench.workload("tiny-lm")["seq"] == 16
    assert "lm_tokens_per_s" in [m["name"] for m in
                                 bench.metrics("tiny-lm", "end_to_end")]
