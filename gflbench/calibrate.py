"""The readings that the check's limits are set from: a cell's numbers
compared on many seeds for the program, the control and the planted
faults.  Not part of a benchmark run.

    python3 gflbench/calibrate.py --workload lm-silo --seeds 1-12 \
        --controls 3 --faults half_batch,answer --fault-seeds 3 \
        --out build/calibrate-lm-silo.jsonl

Each seed runs the cell's set-up and, for the Section V runs, as many
runs as the check replays, then the check.  The control is the plain
reference computed one precision below the configuration's (bfloat16 for
the Section V runs' float32; TF32 for the LM's float32 with TF32 off) in
the program's place; a fault is planted in the program
(:mod:`gflbench.faults`).  One JSON line a reading.
"""
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import torch  # noqa: E402

from gflbench.faults import planted  # noqa: E402
from gflbench.harness import Bench, driver_class  # noqa: E402
from gflbench.trace import Spans  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def reading(bench, cell, seed, device, kind="program", fault=None):
    entry = bench.cell(cell)
    wl = bench.workload(cell)
    drv = driver_class(wl["driver"])(bench.config(entry["config"]), wl,
                                     seed, device, Spans())
    t0 = time.perf_counter()
    if fault:
        with planted(fault, wl["driver"]):
            drv.setup()
            window = drv.units(count=wl.get("check_runs", 1))
    else:
        drv.setup()
        window = drv.units(count=wl.get("check_runs", 1))
    stand_in = None
    if kind == "control":
        if wl["driver"] == "gfl_runs":
            def stand_in(i):
                return drv.reference(i, torch.bfloat16)
        else:
            def stand_in():
                return drv.reference(tf32=True)
    drv.free()
    numbers = drv.check(window, stand_in)
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell, "seed": seed, "kind": fault or kind,
            "numbers": numbers, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    device = torch.device(args.device)
    todo = [(s, "program", None) for s in seeds(args.seeds)]
    todo += [(s, "control", None) for s in seeds(args.seeds)[:args.controls]]
    todo += [(s, "fault", f) for f in filter(None, args.faults.split(","))
             for s in seeds(args.seeds)[:args.fault_seeds]]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as fh:
        for seed, kind, fault in todo:
            rec = reading(bench, args.workload, seed, device, kind, fault)
            print(json.dumps(rec), flush=True)
            fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
