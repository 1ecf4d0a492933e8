"""Fleet demo: a P=4 multi-process fleet survives a SIGKILL mid-buffer
(mirrors ``examples/fleet_demo.py``).

Spawns four worker processes (one per GFL server) behind the selected
transport, SIGKILLs one of them at a tick where its buffer holds unflushed
folded contributions, and lets the coordinator's heartbeat/retry machinery
restart it from its write-ahead checkpoint.  Because every random draw is
pure in ``(seed, server, tick/version)`` and checkpoints are published
crash-atomically BEFORE replies leave the worker, the restarted server
resumes with zero lost folded contributions: the killed run's flush
schedule, q-ledgers and MSD trajectory are identical to the never-killed
twin's — which this script asserts.  On a card every worker folds through
K1 + K2 and the coordinator combines through K3.

    PYTHONPATH=src python -m repro_torch.launch.fleet_demo            # filelog
    PYTHONPATH=src python -m repro_torch.launch.fleet_demo --transport socket
    PYTHONPATH=src python -m repro_torch.launch.fleet_demo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fleet_demo \\
        --telemetry jsonl:runs/fleet_demo.jsonl   # then: watch --once

Prints a ``# device`` line, then the two runs' numbers and the
per-transport throughput as ``name,value,device`` lines.  Nothing is written
to a file but the telemetry sink asked for.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.fleet import FleetProblem, chaos_run, run_fleet
from repro_torch.launch.kernel_bench import device_name
from repro_torch.telemetry import session

# buffer=6 with events=4/tick: buf_n is 4 (mid-buffer) on even ticks —
# killing at tick 2 destroys unflushed folded contributions unless the
# write-ahead checkpoint brings them back
KILL_TICK = 2
KILL_SERVER = 2
TICKS = 10


def build_problem() -> FleetProblem:
    return FleetProblem(P=4, K=16, n=12, buffer=6, events=4,
                        sigma_g=0.2, seed=3)


def chaos(prob: FleetProblem, transport: str, ticks: int, root: str,
          device=None):
    return chaos_run(prob, f"fleet:transport={transport},timeout=5",
                     ticks=ticks, ckpt_root=root,
                     kill_at={KILL_TICK: [KILL_SERVER]}, device=device)


def check_exact(out) -> None:
    """The robustness contract: the kill cost NOTHING.  Raises otherwise."""
    clean, faulted = out.clean, out.faulted
    faults = []
    if not (faulted.kills == 1 and faulted.restarts >= 1):
        faults.append("the kill/restart path was never exercised")
    if not np.array_equal(faulted.flushed, clean.flushed):
        faults.append("flush schedules diverged: folded contributions "
                      "were lost")
    if faulted.q_ledgers != clean.q_ledgers:
        faults.append("worker q-ledgers diverged: privacy accounting "
                      "would drift")
    if not out.msd_gap < 1e-9:
        faults.append(f"faulted run left the clean run's neighborhood "
                      f"(gap={out.msd_gap})")
    if faults:
        raise RuntimeError("; ".join(faults))


def run(transport: str = "filelog", ticks: int = TICKS, device=None,
        telemetry: str = "") -> dict:
    """The drill: the chaos run on ``transport``, checked exact, and the
    never-killed inproc run for throughput.  Returns {"out": ChaosOutcome,
    "inproc": FleetRunResult}."""
    dev = resolve_device(device)
    prob = build_problem()
    with tempfile.TemporaryDirectory(prefix="fleet_demo_") as root:
        if telemetry:
            with session(telemetry):
                out = chaos(prob, transport, ticks, root, dev)
        else:
            out = chaos(prob, transport, ticks, root, dev)
    check_exact(out)
    with tempfile.TemporaryDirectory(prefix="fleet_tp_") as root:
        inproc = run_fleet(prob, "fleet", ticks,
                           ckpt_root=os.path.join(root, "inproc"),
                           device=dev)
    return {"out": out, "inproc": inproc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", default="filelog",
                    choices=("inproc", "filelog", "socket"))
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--telemetry", default="",
                    help="sink spec for the coordinator's 'fleet' stream, "
                         "e.g. jsonl:runs/fleet_demo.jsonl")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = device_name(dev)
    prob = build_problem()
    print(f"# device: {name}", flush=True)
    print(f"# fleet demo: P={prob.P} servers over '{args.transport}', "
          f"SIGKILL worker{KILL_SERVER} at tick {KILL_TICK} (mid-buffer), "
          f"{args.ticks} ticks", flush=True)
    res = run(args.transport, args.ticks, dev, args.telemetry)
    out, inproc = res["out"], res["inproc"]
    clean, faulted = out.clean, out.faulted
    recovery = faulted.recovery_s[0] if faulted.recovery_s else 0.0
    tps = {"inproc": inproc.ticks_per_s, args.transport: clean.ticks_per_s}
    rows = [
        ("clean_msd_last", float(clean.msd[-1])),
        ("clean_flushes", int(clean.flushed.sum())),
        ("faulted_msd_last", float(faulted.msd[-1])),
        ("faulted_flushes", int(faulted.flushed.sum())),
        ("kills", faulted.kills), ("restarts", faulted.restarts),
        ("retries", faulted.retries),
        ("recovery_s", recovery),
        ("msd_gap", out.msd_gap),
        *((f"ticks_per_s[{k}]", v) for k, v in sorted(tps.items())),
    ]
    for key, value in rows:
        print(f"{key},{value!r},{name}")
    print(f"# recovery exact: msd gap {out.msd_gap:.1e}, identical flush "
          f"schedule and q-ledgers", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
