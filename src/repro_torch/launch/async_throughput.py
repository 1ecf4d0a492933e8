"""Async-engine benchmark: buffer/staleness sweep at a fixed event budget
(mirrors ``benchmarks/async_throughput.py``).

    PYTHONPATH=src python -m repro_torch.launch.async_throughput
    PYTHONPATH=src python -m repro_torch.launch.async_throughput --reduced --device cpu

At a FIXED candidate-event budget (ticks x P x rate) it runs the
``scan=True`` event executor (the whole horizon realized once, one tick
captured as a CUDA graph and replayed on a card) over a grid of buffer
sizes x staleness bounds, and reports per configuration the events folded
a second (valid arrivals over the host wall of the run, ending in a
synchronize; the run's warm-up tick and graph capture included, as each
run captures its own graph), the ticks to the target loss (the first tick
at or below the synchronous engine's median MSD), the realized release
cadence (mean flushes a server), the mean folded age and the drops at the
staleness bound.  The synchronous row runs the sync-limit spec
(``async:buffer=<rate>``, uniform cohort) on the same arrival bandwidth.

The reference's setting: a synthetic ``hetero`` population (N=50, M=2,
data seed 0), P=8, K=400, rate 8, 150 ticks, ring, hybrid, sigma 0.05, mu
0.1, B 10, batch 10, cohort ``uniform+trace:diurnal,period=12,min=0.4``,
buffers 4/8/16 x max_stale 2/4 with ``latency=lognorm:0.5``; w_ref from 32
clients a server (500 GD iterations); a 2-tick warm-up run before each
timed one.  The ticks run through the CUDA kernels (``use_kernels``), as
every entry of the port does; the reference bench runs the plain ops.
``--reduced``: P=4, K=100, rate 4, 40 ticks, buffers 2/4/8.

Prints a ``# device`` line and CSV rows (``config`` is ``sync`` or
``buf<b>_stale<s>``).  Nothing is written to a file.
"""
from __future__ import annotations

import argparse
import csv
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core.events import run_gfl_async
from repro_torch.core.population import SyntheticPopulation, estimate_w_ref
from repro_torch.launch.kernel_bench import device_name

BUFFERS = (4, 8, 16)
STALE_BOUNDS = (2, 4)
COLUMNS = ("config", "buffer", "max_stale", "rate", "ticks",
           "events_folded", "seconds", "events_per_sec",
           "releases_per_server_mean", "mean_staleness", "dropped_stale",
           "msd_final", "ticks_to_target", "target_msd")


def ticks_to_target(msd: np.ndarray, target: float) -> int:
    """First tick index at/below target, or -1 if never reached."""
    hit = np.nonzero(msd <= target)[0]
    return int(hit[0]) if hit.size else -1


def timed_run(pop, cfg: GFLConfig, *, ticks: int, batch_size: int, w_ref):
    """(result, wall s) of a ``scan=True`` run after a 2-tick warm-up."""
    run_gfl_async(pop, cfg, ticks=2, batch_size=batch_size, seed=0,
                  w_ref=w_ref, scan=True)
    cuda = pop.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(pop.device)
    t0 = time.perf_counter()
    res = run_gfl_async(pop, cfg, ticks=ticks, batch_size=batch_size,
                        seed=0, w_ref=w_ref, scan=True)
    if cuda:
        torch.cuda.synchronize(pop.device)
    return res, time.perf_counter() - t0


def row(name: str, res, dt: float, target: float) -> dict:
    spec = res.spec
    events = int(res.events.sum())
    return {"config": name, "buffer": spec.buffer,
            "max_stale": spec.max_stale, "rate": spec.events_per_tick,
            "ticks": len(res.msd), "events_folded": events, "seconds": dt,
            "events_per_sec": events / dt,
            "releases_per_server_mean": float(res.flushed.sum(0).mean()),
            "mean_staleness": float(res.staleness.mean()),
            "dropped_stale": int(res.dropped_stale.sum()),
            "msd_final": float(res.msd[-1]),
            "ticks_to_target": ticks_to_target(res.msd, target),
            "target_msd": target}


def run(reduced: bool = False, ticks=None, device=None, P: int = 8,
        K: int = 400, rate: int = 8, batch_size: int = 10) -> list:
    if reduced:
        P, K, rate = 4, 100, 4
        ticks = 40 if ticks is None else ticks
    ticks = 150 if ticks is None else ticks
    buffers = tuple(max(2, b // 2) for b in BUFFERS) if reduced else BUFFERS
    dev = resolve_device(device)
    pop = SyntheticPopulation(P, K, mode="hetero", N=50, M=2, data_seed=0,
                              device=dev)
    w_ref = estimate_w_ref(pop, sample_clients=min(32, K), iters=500)
    base = GFLConfig(num_servers=P, clients_per_server=K,
                     clients_sampled=rate, topology="ring",
                     privacy="hybrid", sigma_g=0.05, mu=0.1,
                     grad_bound=10.0,
                     cohort="uniform+trace:diurnal,period=12,min=0.4",
                     use_kernels=True)
    # the synchronous baseline on the same arrival bandwidth: the
    # sync-limit spec (buffer = rate, zero latency) over a uniform cohort
    sync, dt = timed_run(pop, replace(base, cohort="uniform",
                                      async_spec=f"async:buffer={rate}"),
                         ticks=ticks, batch_size=batch_size, w_ref=w_ref)
    target = float(np.median(sync.msd))
    rows = [row("sync", sync, dt, target)]
    for b in buffers:
        for s in STALE_BOUNDS:
            spec = (f"async:buffer={b},latency=lognorm:0.5,max_stale={s},"
                    f"rate={rate}")
            res, dt = timed_run(pop, replace(base, async_spec=spec),
                                ticks=ticks, batch_size=batch_size,
                                w_ref=w_ref)
            rows.append(row(f"buf{b}_stale{s}", res, dt, target))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="P=4, K=100, rate 4, 40 ticks, buffers 2/4/8")
    ap.add_argument("--ticks", type=int, default=None,
                    help="event batches a config (default: 150, reduced 40)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows = run(args.reduced, args.ticks, dev)
    out = csv.writer(sys.stdout, lineterminator="\n")
    out.writerow(COLUMNS)
    for r in rows:
        out.writerow([f"{r[c]:.6g}" if isinstance(r[c], float) else r[c]
                      for c in COLUMNS])
    return rows


if __name__ == "__main__":
    main()
