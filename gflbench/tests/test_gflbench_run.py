"""A run of the harness on the CPU, past its look for a card: the tiny
cells come out correct, the last line has the contract's keys, and the
end-to-end metrics are taken over every unit and the whole window."""
import time

import numpy as np
import pytest
import torch

from gflbench.harness import Bench, Run, result_line, run_cell
from gflbench.trace import Trace

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny-sec5", "tiny-lm"])
def test_tiny_cell_is_correct(tiny_root, cell):
    bench = Bench(tiny_root)
    res = run_cell(bench, cell, 2 ** 31 + 7, 0.5, False,
                   torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in bench.metrics(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    line = result_line(res, "cpu", 1)
    assert list(line) == KEYS + ["compared"]
    assert set(line["compared"]) == set(bench.workload(cell)["limits"])


def test_traced_line_has_its_breakdown(tiny_root):
    res = run_cell(Bench(tiny_root), "tiny-sec5", 3, 0.2, True,
                   torch.device("cpu"), time.perf_counter())
    line = result_line(res, "cpu", 1)
    assert list(line) == KEYS + ["breakdown", "compared"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _run(window, driver="gfl_runs", **workload):
    return Run("c", {}, dict(workload, driver=driver), 1.0, window, {})


def test_rates_and_tail_over_every_unit_and_the_whole_window(tiny_root):
    bench = Bench(tiny_root)
    walls = list(np.linspace(0.08, 0.3, 250))
    run = _run({"units": 250, "seconds": 31.5, "rounds": 250 * 500,
                "unit_s": walls, "capture_s": [0.004] * 250})
    assert bench.reader("sec5_rounds_per_s")(run) == 250 * 500 / 31.5
    assert bench.reader("sec5_run_ms_p90")(run) == pytest.approx(
        1e3 * np.percentile(walls, 90))
    lm = _run({"units": 21, "seconds": 30.7, "tokens": 21 * 32768,
               "grad_s": [1.0] * 21, "step_s": [1.01] * 21},
              driver="lm_rounds", seq=2048)
    assert bench.reader("lm_tokens_per_s")(lm) == 21 * 32768 / 30.7
    assert bench.reader("lm_fold_combine_ms")(lm) == pytest.approx(10.0)
    # a reader finds nothing to read in a record that lacks its field
    assert bench.reader("lm_tokens_per_s")(run) is None


def test_idle_of_the_untraced_window_from_the_traced_busy_time(tiny_root):
    """Two traced runs of 500 rounds busy 0.1 s in all: 1e-4 s a round;
    the window's 6,000 rounds a second keep the device busy 60 %."""
    ops = [("k", 0, 40_000_000), ("k", 30_000_000, 100_000_000)]
    trace = Trace(0.4, ops, [], units=2)
    run = Run("c", {}, {"driver": "gfl_runs", "rounds": 500}, 1.0,
              {"units": 600, "seconds": 50.0, "rounds": 300_000}, {}, trace)
    assert trace.busy_s == pytest.approx(0.1)
    assert Bench(tiny_root).reader("sec5_device_idle")(run) == \
        pytest.approx(40.0)
