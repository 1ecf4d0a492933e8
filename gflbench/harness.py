"""The benchmark of the port: one command runs one cell once.

    python3 gflbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration and traffic; the configuration is ``configs/<config>.json``,
the traffic ``workloads/<cell>.json``, whose ``driver`` names the module
under ``drivers/`` that runs it; each metric is ``metrics/<metric>.py``,
whose ``read(run)`` takes its number from the run's record (a
:class:`Run`) or returns None where it finds nothing to read.  A new cell,
configuration or metric is new files and new entries in
``BENCHMARK.json``.

A run: set-up (the driver's, every shape the window uses warmed up), the
window (units until ``--seconds`` have passed and the last one has
finished), the device's peak memory, with ``--trace 1`` a traced
sub-window of the workload's ``trace_units`` units after the window, so
that the profiler, which stays attached once started, slows no unit of
the window, then the check against the plain reference, once the
program's state is freed.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are its last key and the last lines of standard error.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from gflbench.trace import Spans, Trace, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a number compared that is not finite is reported as this, and fails
NOT_FINITE = 1e30


@dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    config: dict
    workload: dict
    setup_s: float
    window: dict
    spans: dict
    trace: Trace | None = None


class Bench:
    """The benchmark at ``root``: its cells, configurations and metrics."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cells(self) -> list:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                         f"{', '.join(self.cells())}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def workload(self, cell: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{cell}.json")
                          .read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The metric entries of ``kind`` (``end_to_end`` or ``per_layer``)
        that the cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"gflbench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def driver_class(name: str):
    return importlib.import_module(f"gflbench.drivers.{name}").Driver


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """One run of ``cell``; returns the result's fields (without the
    device's)."""
    import torch
    entry = bench.cell(cell)
    config = bench.config(entry["config"])
    workload = bench.workload(cell)
    spans = Spans()
    drv = driver_class(workload["driver"])(config, workload, seed, device,
                                           spans)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    window = drv.units(seconds=seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = None
    if trace:
        n = workload["trace_units"]
        _, tr = traced(lambda: drv.units(count=n), spans)
        tr.units = n
    run = Run(cell, config, workload, setup_s, window, dict(spans.seconds),
              tr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(cell, kind):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    drv.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {k: v if math.isfinite(v) else NOT_FINITE
               for k, v in drv.check(window).items()}
    limits = workload["limits"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()}
    correct = (set(numbers) == set(limits)
               and all(v <= limits[k] for k, v in numbers.items()))
    out = {"correct": correct, "attempted": window["units"], "failed": 0,
           "metrics": metrics, "peak": peak, "compared": compared}
    if tr is not None:
        out["trace"] = tr
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(Path(__file__).resolve().parents[1])
    chips = bench.cell(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(bench, args.workload, args.seed % 2 ** 63, args.seconds,
                   bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(res, torch.cuda.get_device_name(0), chips)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def result_line(res: dict, kind: str, chips: int) -> dict:
    """The result's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and last the
    numbers compared beside their limits."""
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(res["peak"])}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": dev}
    tr = res.get("trace")
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["compared"] = res["compared"]
    return line
