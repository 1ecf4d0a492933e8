#!/usr/bin/env python3
"""Time the kernels of two checkouts on one card, in turns.

    python3 chip_ab.py PARENT [CHANGE]
    python3 chip_ab.py --rounds PAIRS PARENT [CHANGE]

PARENT and CHANGE are checkouts of the repository (CHANGE defaults to the
one holding this script).  Each is run in a process of its own, in the
order parent, change, change, parent (with ``--rounds``, PAIRS pairs,
the side that runs first alternating), so that both meet the card in the
same states; each builds its own kernels under its own build/kernels.

A run imports its own checkout's ``chip_smoke`` and calls its timing
functions on inputs from seed 0: ``time_shape`` at each of its ``SHAPES``
(K1-K3) and ``single_server_timings`` (K5-K7 at the shapes its tables
name).  So the kernels, shapes and measurements are whatever each
checkout's chip_smoke times, and a change to a kernel or its shapes needs
no edit here.  K8 is timed only inside chip_smoke's ``phase_swa``, beside
its checks, and not here.  ``--rounds`` times whole rounds instead: the
steady graph round (``steady_ms`` of ``gfl_runner``) of gfl-logreg under
hybrid in each of ``ROUND_FAULTS``, the faulted rounds whose host stage
copies A_i and the masks.

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
# --rounds: resilience_demo's "flaky links" and "everything at once"
ROUND_FAULTS = ("links:0.2",
                "links:0.1+outage:0.05+straggler:0.2,stale=2+dropout:0.2")


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


def one_rounds(src: Path) -> dict:
    """Steady graph ms a round of checkout ``src`` in each ROUND_FAULTS."""
    sys.path[:0] = [str(src), str(src / "src")]
    from dataclasses import replace

    import torch
    import chip_smoke as cs
    from repro_torch import rng
    from repro_torch.configs import gfl_logreg
    from repro_torch.core.simulate import generate_problem

    assert Path(cs.__file__).resolve().parent == src, cs.__file__
    cs.phase_build()
    base = gfl_logreg.GFL
    prob = generate_problem(rng(0, "cuda"), P=base.num_servers,
                            K=base.clients_per_server,
                            N=gfl_logreg.SAMPLES_PER_CLIENT,
                            M=gfl_logreg.DIM, rho=gfl_logreg.RHO)
    rows = {}
    for fault in ROUND_FAULTS:
        cfg = replace(base, privacy="hybrid", fault=fault, use_kernels=True)
        rows[f"graph round {fault}"] = {"ms": cs.steady_ms(
            torch, cs.gfl_runner(prob, cfg), "graph")}
    return {"src": str(src), "rows": rows}


def main(argv) -> int:
    if argv and argv[0] in ("--one", "--one-rounds"):
        run = one if argv[0] == "--one" else one_rounds
        print(json.dumps(run(Path(argv[1]).resolve())), flush=True)
        return 0
    mode, pairs = "--one", 2
    if argv and argv[0] == "--rounds":
        mode, pairs, argv = "--one-rounds", int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    runs = []
    order = []
    for i in range(pairs):
        pair = [("parent", parent), ("change", change)]
        order += pair if i % 2 == 0 else pair[::-1]
    for label, src in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               mode, str(src)], capture_output=True,
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
