"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest gflbench/tests``; the repository's suite does not
collect them).  ``tiny_bench`` is a copy of the benchmark with two
dummy cells added as new files alone: the Section V runs and the
federated LM at sizes a CPU runs in seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_LM = {"hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "vocab_size": 256}


def add_cell(root: Path, cell: str, base_cell: str, config: str,
             config_changes: dict, workload_changes: dict) -> None:
    """Add ``cell`` and its configuration ``config`` to the benchmark at
    ``root`` by new files, copied from ``base_cell``'s with changes, and
    entries in ``BENCHMARK.json``: every metric of the base cell lists it."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in spec["workloads"] if w["name"] == base_cell)
    base_cfg = next(c for c in spec["configs"] if c["name"] == base["config"])
    cfg = json.loads((root / base_cfg["file"]).read_text())
    cfg.update(config_changes, name=config)
    (root / "gflbench/configs" / f"{config}.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "gflbench/workloads" / f"{base_cell}.json")
                    .read_text())
    wl.update(workload_changes)
    (root / "gflbench/workloads" / f"{cell}.json").write_text(json.dumps(wl))
    spec["configs"].append(dict(base_cfg, name=config,
                                file=f"gflbench/configs/{config}.json"))
    spec["workloads"].append(dict(base, name=cell, config=config,
                                  traffic=cell))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base_cell in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    from gflbench.reference.smollm import flat_size
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "gflbench", root / "gflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_cell(root, "tiny-sec5", "sec5-hybrid", "tiny-logreg",
             {"P": 3, "K": 4, "N": 8, "batch_size": 2},
             {"rounds": 20, "warmup_runs": 1, "check_runs": 3,
              "executor": None})
    lm = dict(TINY_LM, parameters=flat_size(TINY_LM))
    add_cell(root, "tiny-lm", "lm-silo", "tiny-lm", lm,
             {"servers": 2, "clients": 2, "per_client": 1, "seq": 16})
    card = dict(json.loads((ROOT / "gflbench/configs/smollm-135m.json")
                           .read_text()), num_hidden_layers=4)
    card["parameters"] = flat_size(card)
    add_cell(root, "tiny-lm-card", "lm-silo", "smollm-135m-4l", card,
             {"servers": 2, "clients": 2, "per_client": 1, "seq": 512})
    return root
