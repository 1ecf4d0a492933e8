"""Population-scale demo: a virtual fleet of 100,000 clients a server
(mirrors ``examples/population_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.population_demo
    PYTHONPATH=src python -m repro_torch.launch.population_demo --reduced --device cpu

  1. a LAZY synthetic population (``synthetic:hetero,lo=0.5,hi=1.5``): no
     [P, K, N, M] tensor exists, every client's shard is a pure function
     of (data_seed, server, client);
  2. cohort scheduling, uniform, then under a diurnal availability trace,
     then gradient-norm importance sampling with unbiased 1/(K pi)
     reweighting under the same trace;
  3. subsampling-amplified privacy accounting: the hybrid mechanism's
     ledger charged at the realized cohort rate q = L/K instead of full
     participation, beside the scheduled mechanism's (epsilon <= 10).

P=8 servers x K=100,000 clients, L=20 a round, N=100 samples a client,
M=2, hypercube, hybrid, sigma 0.2, mu 0.1, B 10, 120 rounds, batch 10,
seed 1; w_ref from a Monte-Carlo subsample of 64 clients a server (1500
GD iterations).  ``--reduced``: 20 rounds, 16 clients a server and 300
iterations for w_ref.  The rounds run through the CUDA kernels
(``use_kernels``), under the round graph on a card.

Prints a ``# device`` line, CSV rows ``cohort,msd_tail,q_mean`` (the tail
is the mean MSD over the last tenth of the rounds), then ``name,value``
lines of the epsilons.  Nothing is written to a file.
"""
from __future__ import annotations

import argparse
import csv
import sys
from dataclasses import replace

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core.population import (
    estimate_w_ref,
    population_from_spec,
    run_gfl_population,
)
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.launch.kernel_bench import device_name

P, K, L, ITERS = 8, 100_000, 20, 120
COHORTS = ("uniform",
           "uniform+trace:diurnal,period=24,min=0.2",
           "importance,floor=0.2+trace:diurnal,period=24,min=0.2")


def base_config() -> GFLConfig:
    return GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=L,
                     topology="hypercube", privacy="hybrid", sigma_g=0.2,
                     mu=0.1, grad_bound=10.0,
                     population="synthetic:hetero,lo=0.5,hi=1.5",
                     use_kernels=True)


def run(iters: int = ITERS, reduced: bool = False, device=None,
        executor=None):
    """(rows (cohort, msd_tail, q_mean, result), epsilons {name: value})."""
    sample, ref_iters = 64, 1500
    if reduced:
        iters, sample, ref_iters = 20, 16, 300
    base = base_config()
    pop = population_from_spec(base, device=device)
    w_ref = estimate_w_ref(pop, sample_clients=sample, iters=ref_iters)
    rows = []
    for cohort in COHORTS:
        res = run_gfl_population(pop, replace(base, cohort=cohort),
                                 iters=iters, batch_size=10, seed=1,
                                 w_ref=w_ref, executor=executor)
        tail = float(np.mean(res.msd[-max(iters // 10, 1):]))
        rows.append((cohort, tail, float(res.q.mean()), res))
    q = L / K
    acc = mechanism_for(base).accountant()
    acc.advance(iters, q=q)
    sched = replace(base, privacy="scheduled", epsilon_target=10.0,
                    epsilon_horizon=iters)
    acc_s = mechanism_for(sched).accountant()
    acc_s.advance(iters, q=q)
    eps = {"hybrid_epsilon": acc.epsilon(),
           "hybrid_epsilon_amplified": acc.amplified_epsilon(),
           "scheduled_epsilon": acc_s.epsilon(),
           "scheduled_epsilon_amplified": acc_s.amplified_epsilon()}
    return rows, eps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="20 rounds, a smaller w_ref subsample")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows, eps = run(args.iters, args.reduced, dev)
    out = csv.writer(sys.stdout, lineterminator="\n")
    out.writerow(["cohort", "msd_tail", "q_mean"])
    for cohort, tail, q_mean, _ in rows:
        out.writerow([cohort, f"{tail:.6g}", f"{q_mean:.6g}"])
    for name, value in eps.items():
        print(f"population_demo/{name},{value:.6g}")
    return rows, eps


if __name__ == "__main__":
    main()
