"""Population-scale benchmark: a virtual K sweep at a fixed cohort size L
(mirrors ``benchmarks/population_scale.py``).

    PYTHONPATH=src python -m repro_torch.launch.population_scale
    PYTHONPATH=src python -m repro_torch.launch.population_scale --reduced --device cpu

K is virtual: memory and compute scale with the sampled cohort [P, L],
not the population [P, K].  For K in {50, 10^3, 10^5} at fixed L it
reports the client-steps a second of a ``scan=True`` run (the reference's
whole-run ``lax.scan``; here its rounds under the round graph on a card)
and, on a card, the peak device bytes of that run
(``torch.cuda.max_memory_allocated`` after a reset, everything the process
holds included), and ASSERTS at every K that the peak stays below what the
dense ``[P, K, N, M]`` f32 tensor alone would take (640 MB at K = 10^5),
or below 8 MiB where that tensor is smaller.  On the CPU peak memory is
not measured and not asserted.

A synthetic ``hetero`` population (N=100, M=2, data seed 0), P=8, L=10,
ring, hybrid, sigma 0.2, mu 0.1, B 10, batch 10, 100 rounds; w_ref from 8
clients a server (200 GD iterations), outside the timed run, and a 2-round
warm-up run before it.  The rounds run through the CUDA kernels
(``use_kernels``), as every entry of the port does; this departs from
the reference bench, which runs the config's default, the plain ops.
With those ops the combine's ``torch.matmul`` has cuBLAS keep a
workspace for the stream it runs on (32 MiB a stream on Hopper) for the
life of the process, which alone is above the 8 MiB budget of the K = 50
and 10^3 rows.  The timed run includes the graph's capture (host clock
around work ending in a synchronize).  ``--reduced``: P=4, L=5,
N=50, 20 rounds, the same K sweep.

Prints a ``# device`` line and CSV rows ``virtual_K,P,L,N,iters,seconds,
client_steps_per_sec,peak_bytes,dense_bytes,budget_bytes,q``, then the
peak's ratio between the largest and smallest K.  Nothing is written to a
file.
"""
from __future__ import annotations

import argparse
import csv
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core.population import (
    SyntheticPopulation,
    estimate_w_ref,
    run_gfl_population,
)
from repro_torch.launch.kernel_bench import device_name

VIRTUAL_KS = (50, 1_000, 100_000)
OVERHEAD_BYTES = 8 * 2 ** 20   # the budget where the dense tensor is smaller
COLUMNS = ("virtual_K", "P", "L", "N", "iters", "seconds",
           "client_steps_per_sec", "peak_bytes", "dense_bytes",
           "budget_bytes", "q")


def bench_one(K: int, *, P: int, L: int, N: int, iters: int,
              batch_size: int, device) -> dict:
    """One row: throughput and (on a card) peak bytes of a scan run."""
    dev = torch.device(device)
    pop = SyntheticPopulation(P, K, mode="hetero", N=N, M=2, data_seed=0,
                              device=dev)
    cfg = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=L,
                    topology="ring", privacy="hybrid", sigma_g=0.2, mu=0.1,
                    grad_bound=10.0, use_kernels=True)
    dense = P * K * N * 2 * 4
    budget = max(dense, OVERHEAD_BYTES)
    w_ref = estimate_w_ref(pop, sample_clients=8, iters=200)
    run_gfl_population(pop, cfg, iters=2, batch_size=batch_size, seed=0,
                       scan=True, w_ref=w_ref)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_gfl_population(pop, cfg, iters=iters, batch_size=batch_size,
                             seed=0, scan=True, w_ref=w_ref)
    if cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if peak is not None and peak >= budget:
        raise AssertionError(
            f"population engine peaked at {peak} bytes for K={K}, above the "
            f"{budget}-byte budget (dense [P, K, N, M] {dense} bytes): it "
            "is supposed to never materialize the population")
    return {"virtual_K": K, "P": P, "L": L, "N": N, "iters": iters,
            "seconds": dt, "client_steps_per_sec": P * L * iters / dt,
            "peak_bytes": peak, "dense_bytes": dense, "budget_bytes": budget,
            "q": L / K}


def run(reduced: bool = False, iters=None, device=None, P: int = 8,
        L: int = 10, N: int = 100, batch_size: int = 10) -> list:
    if reduced:
        P, L, N = 4, 5, 50
        iters = 20 if iters is None else iters
    iters = 100 if iters is None else iters
    dev = resolve_device(device)
    return [bench_one(K, P=P, L=min(L, K), N=N, iters=iters,
                      batch_size=batch_size, device=dev) for K in VIRTUAL_KS]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="P=4, L=5, N=50, 20 rounds (the same K sweep)")
    ap.add_argument("--iters", type=int, default=None,
                    help="rounds a K (default: 100, reduced 20)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows = run(args.reduced, args.iters, dev)
    out = csv.writer(sys.stdout, lineterminator="\n")
    out.writerow(COLUMNS)
    for r in rows:
        out.writerow(["not_measured" if r[c] is None else
                      (f"{r[c]:.6g}" if isinstance(r[c], float) else r[c])
                      for c in COLUMNS])
    if rows[0]["peak_bytes"] is not None:
        print("population_scale/peak_ratio_K1e5_vs_K50,"
              f"{rows[-1]['peak_bytes'] / rows[0]['peak_bytes']:.6g}")
    return rows


if __name__ == "__main__":
    main()
