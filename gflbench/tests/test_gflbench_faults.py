"""The check fails what it must: each fault planted in the program, and
the control (the reference one precision below the configuration's in
the program's place), come out not correct under the cells' limits."""
import time

import pytest
import torch

from gflbench.calibrate import reading
from gflbench.faults import FAULTS, planted
from gflbench.harness import Bench, run_cell


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["tiny-sec5", "tiny-lm"])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    bench = Bench(tiny_root)
    driver = bench.workload(cell)["driver"]
    with planted(fault, driver):
        res = run_cell(bench, cell, 11, 0.2, False, torch.device("cpu"),
                       time.perf_counter())
    assert not res["correct"], res["compared"]


def test_control_is_not_correct_on_the_cpu(tiny_root):
    bench = Bench(tiny_root)
    rec = reading(bench, "tiny-sec5", 12, torch.device("cpu"), "control")
    limits = bench.workload("tiny-sec5")["limits"]
    assert any(rec["numbers"][k] > limits[k] for k in limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sec5-hybrid", "tiny-lm-card"])
def test_control_is_not_correct_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LM's control is TF32, which "
                    "only the card has")
    bench = Bench(tiny_root)
    rec = reading(bench, cell, 13, torch.device("cuda"), "control")
    limits = bench.workload(cell)["limits"]
    assert any(rec["numbers"][k] > limits[k] for k in limits), rec
