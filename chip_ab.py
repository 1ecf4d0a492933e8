#!/usr/bin/env python3
"""Time the kernels of two checkouts on one card, in turns.

    python3 chip_ab.py PARENT [CHANGE]

PARENT and CHANGE are checkouts of the repository (CHANGE defaults to the
one holding this script).  Each is run in a process of its own, in the
order parent, change, change, parent, so that both meet the card in the
same states; each builds its own kernels under its own build/kernels.

A run imports its own checkout's ``chip_smoke`` and calls its timing
functions on inputs from seed 0: ``time_shape`` at each of its ``SHAPES``
(K1-K3) and ``single_server_timings`` (K5-K7 at the shapes its tables
name).  So the kernels, shapes and measurements are whatever each
checkout's chip_smoke times, and a change to a kernel or its shapes needs
no edit here.  K8 is timed only inside chip_smoke's ``phase_swa``, beside
its checks, and not here.

Prints a JSON line a run, then one with every row both sides timed (a row
is a kernel, or a mode of one, at a shape), each side's two readings of
its ``READ`` keys, then the rows only one side timed, then the card's
name and power limit from nvidia-smi.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the keys of a timing record read here, where the checkout gives them
READ = ("ms", "device_ms", "device_ops_per_call", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "design_bytes")


def one(src: Path) -> dict:
    """Every timing record of checkout ``src``'s chip_smoke, by row."""
    sys.path[:0] = [str(src), str(src / "src")]
    import torch
    import chip_smoke as cs

    assert Path(cs.__file__).resolve().parent == src, cs.__file__
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for shape in cs.SHAPES:
        for name, rec in cs.time_shape(torch, *shape, gen).items():
            rows[f"{name} {list(shape)}"] = rec
        torch.cuda.empty_cache()
    for (name, _), rec in cs.single_server_timings(torch, gen).items():
        rows[f"{name} {rec['shape']}"] = rec
    return {"src": str(src),
            "rows": {row: {k: rec[k] for k in READ if k in rec}
                     for row, rec in rows.items()}}


def main(argv) -> int:
    if argv and argv[0] == "--one":
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    runs = []
    for label, src in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", str(src)], capture_output=True,
                              text=True, cwd=src, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        print(json.dumps(run), flush=True)
        runs.append(run)
    sides = {side: [r["rows"] for r in runs if r["label"] == side]
             for side in ("parent", "change")}
    both = [row for row in sides["change"][0] if row in sides["parent"][0]]
    print(json.dumps({"ab": [
        {"row": row, **{side: [r[row] for r in rs]
                        for side, rs in sides.items()}} for row in both]}),
        flush=True)
    print(json.dumps({"only": {
        side: sorted(set(rs[0]) - set(both)) for side, rs in sides.items()}}),
        flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
