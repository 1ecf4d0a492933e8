"""Telemetry overhead: the population scan with telemetry off and on
(mirrors ``benchmarks/telemetry_overhead.py``).

    PYTHONPATH=src python -m repro_torch.launch.telemetry_overhead
    PYTHONPATH=src python -m repro_torch.launch.telemetry_overhead --reduced --device cpu

The observability contract is two-sided: ``telemetry=off`` is bitwise an
uninstrumented run (the tests hold that half), and ``telemetry=on`` must
stay cheap enough to leave on.  This measures the second half on the
reference's setting: a synthetic ``hetero`` population (P=4, K=50, L=5,
N=50, M=2, data seed 0), ring, hybrid, sigma 0.2, mu 0.1, B 10, batch 10,
``run_gfl_population(scan=True)`` for 100 rounds (``--reduced``: 30), the
best of 5 (3) timed runs after a warm-up run, in three arms: telemetry
off, on with the drain's default batch (``flush_every`` 1) and on with
``REPRO_TELEMETRY_FLUSH_EVERY=8``.  The on arms record into a memory sink
of a session opened around the run (no trace file).  On a card each arm
runs under both executors (the round graph and eager), on the CPU eagerly
only; a run's wall ends in a synchronize.  The rounds run through the
CUDA kernels (``use_kernels``), as every entry of the port does.

Prints a ``# device`` line and CSV rows; ``overhead_pct`` is an on arm's
wall over the off arm's of the same executor, less one.  Nothing is
written to a file.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from dataclasses import replace

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core.population import (SyntheticPopulation, estimate_w_ref,
                                         run_gfl_population)
from repro_torch.launch.kernel_bench import device_name
from repro_torch.telemetry import MemorySink, session
from repro_torch.telemetry.stream import ENV_FLUSH_EVERY

BUFFERED_FLUSH_EVERY = 8
COLUMNS = ("device", "executor", "arm", "flush_every", "iters", "seconds",
           "ms_per_round", "records", "overhead_pct")


def _run(pop, cfg, *, iters, w_ref, executor):
    """(wall s, records) of one run, under a memory session when ``cfg``
    is observed."""
    cuda = pop.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(pop.device)
    t0 = time.perf_counter()
    if cfg.telemetry == "off":
        run_gfl_population(pop, cfg, iters=iters, batch_size=10, seed=0,
                           scan=True, w_ref=w_ref, executor=executor)
        records = 0
    else:
        with session([MemorySink()], trace_path="") as sess:
            run_gfl_population(pop, cfg, iters=iters, batch_size=10, seed=0,
                               scan=True, w_ref=w_ref, executor=executor)
            records = sess.records
    if cuda:
        torch.cuda.synchronize(pop.device)
    return time.perf_counter() - t0, records


def time_arm(pop, cfg, *, iters, w_ref, executor, repeats):
    """(best wall s of ``repeats`` runs after a warm-up, records a run)."""
    _run(pop, cfg, iters=iters, w_ref=w_ref, executor=executor)
    runs = [_run(pop, cfg, iters=iters, w_ref=w_ref, executor=executor)
            for _ in range(repeats)]
    return min(r[0] for r in runs), runs[-1][1]


def run(reduced: bool = False, device=None) -> list:
    P, K, L, N = 4, 50, 5, 50
    iters = 30 if reduced else 100
    repeats = 3 if reduced else 5
    dev = resolve_device(device)
    pop = SyntheticPopulation(P, K, mode="hetero", N=N, M=2, data_seed=0,
                              device=dev)
    w_ref = estimate_w_ref(pop, sample_clients=8, iters=200)
    base = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=L,
                     topology="ring", privacy="hybrid", sigma_g=0.2, mu=0.1,
                     grad_bound=10.0, use_kernels=True)
    executors = ("graph", "eager") if dev.type == "cuda" else ("eager",)
    name = device_name(dev)
    rows = []
    for executor in executors:
        off_s, _ = time_arm(pop, base, iters=iters, w_ref=w_ref,
                            executor=executor, repeats=repeats)
        arms = [("off", 1, off_s, 0)]
        previous = os.environ.get(ENV_FLUSH_EVERY)
        for flush_every in (1, BUFFERED_FLUSH_EVERY):
            os.environ[ENV_FLUSH_EVERY] = str(flush_every)
            try:
                on_s, records = time_arm(
                    pop, replace(base, telemetry="memory"), iters=iters,
                    w_ref=w_ref, executor=executor, repeats=repeats)
            finally:
                if previous is None:
                    del os.environ[ENV_FLUSH_EVERY]
                else:
                    os.environ[ENV_FLUSH_EVERY] = previous
            arms.append(("on", flush_every, on_s, records))
        for arm, flush_every, seconds, records in arms:
            rows.append({"device": name, "executor": executor, "arm": arm,
                         "flush_every": flush_every, "iters": iters,
                         "seconds": seconds,
                         "ms_per_round": seconds * 1e3 / iters,
                         "records": records,
                         "overhead_pct": 100.0 * (seconds - off_s) / off_s})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="30 rounds, best of 3")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows = run(args.reduced, dev)
    out = csv.writer(sys.stdout, lineterminator="\n")
    out.writerow(COLUMNS)
    for r in rows:
        out.writerow([f"{r[c]:.6g}" if isinstance(r[c], float) else r[c]
                      for c in COLUMNS])
    return rows


if __name__ == "__main__":
    main()
