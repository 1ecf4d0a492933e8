"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
process imports every module of the harness, its references and its
metrics, runs both tiny cells, and lists the modules whose top-level
name (the part before the first dot, compared whole) is ``jax``,
``jaxlib``, ``flax`` or ``repro``."""
import json
import subprocess
import sys

from conftest import ROOT

SCRIPT = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
from gflbench import calibrate, counts, faults, peaks, trace  # noqa: F401
from gflbench.drivers import gfl_runs, lm_rounds  # noqa: F401
from gflbench.reference import gfl, smollm  # noqa: F401
from gflbench.traffic import section5, tokens, weights  # noqa: F401
from gflbench.harness import Bench, forbidden_modules, run_cell
bench = Bench({tiny!r})
for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
    bench.reader(m["name"])
for cell in ("tiny-sec5", "tiny-lm"):
    run_cell(bench, cell, 5, 0.1, False, torch.device("cpu"),
             time.perf_counter())
print(json.dumps(forbidden_modules()))
"""


def test_no_jax_in_a_run(tiny_root):
    code = SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT),
                         tiny=str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_counts_whole_top_level_names(monkeypatch):
    from gflbench.harness import forbidden_modules
    for name in ("repro_torch", "repro_torch.core", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"repro_torch", "repro_torch.core", "jaxtyping"} & set(
        forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in forbidden_modules()
