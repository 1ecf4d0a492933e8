#!/usr/bin/env python3
"""The JAX reference's Fig. 2 MSD tails on the CPU, their spread over
repeats on the benchmark's problem, and that problem as a data file.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 fig2_reference.py \
        [--repeats 96] [--iters 400] [--save-problem data/fig2_problem0.npz]

Runs ``repro.core.simulate.run_gfl`` at the setting of
``benchmarks/fig2_convergence.py`` (P=10, K=50, L=10, mu 0.1, topology
full, B 10, batch 10, sigma 0.2 and 1.0, every registered mechanism,
``scheduled`` at the budget ``run_schemes`` gives it) on the benchmark's
problem (key 0), with repeat seeds 1000, 1001, ... as ``run_schemes``
numbers them.  A repeat's tail is the mean MSD over the last iters/10
rounds; the benchmark's tail is the mean of repeats 0 and 1.

Prints one JSON line per (sigma, scheme) with its repeat tails, then one
summary line per (sigma, scheme), from which ``chip_smoke.py``'s fig2
constants come:

- ``ref_tail``, the benchmark's tail, and ``log_sd2``, the standard
  deviation of the log of a two-repeat tail over the disjoint pairs of
  repeats.  It bounds how far another two-repeat run on this problem (the
  port's, through ``--problem`` of ``repro_torch.launch.fig2_convergence``)
  may fall from ``ref_tail``: the smoke's band is ``|log(port /
  ref_tail)| <= FIG2_BAND_SDS * sqrt(2) * log_sd2``.
- ``log_mean`` and ``log_sd``, the mean and standard deviation of the log
  of one repeat's tail over every repeat, against which the smoke holds
  the mean log tail of the port's own repeats (within FIG2_BAND_SDS
  standard errors of the difference).

``--save-problem`` writes the problem as an ``.npz`` of plain arrays
(features, labels, rho, w_opt), which the port loads without JAX.

This script imports the reference and never runs on the card.
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np

from repro.configs.base import GFLConfig
from repro.core.privacy.accountant import epsilon_at
from repro.core.privacy.mechanism import list_mechanisms
from repro.core.simulate import generate_problem, run_gfl

SIGMAS = (0.2, 1.0)
P, K, L, MU, B, BATCH = 10, 50, 10, 0.1, 10.0, 10


def repeat_tails(prob, scheme, sigma, iters, repeats):
    eps = epsilon_at(iters, MU, B, sigma) if sigma > 0 else 0.0
    cfg = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=L,
                    topology="full", privacy=scheme, sigma_g=sigma, mu=MU,
                    grad_bound=B, epsilon_target=eps, epsilon_horizon=iters)
    n = max(iters // 10, 5)
    out = []
    for r in range(repeats):
        msd, _ = run_gfl(prob, cfg, iters=iters, batch_size=BATCH,
                         seed=1000 + r)
        out.append(float(np.mean(np.asarray(msd)[-n:])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=96)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--save-problem", default=None,
                    help="write the problem to this .npz file")
    args = ap.parse_args(argv)
    prob = generate_problem(jax.random.PRNGKey(0), P=P, K=K)
    if args.save_problem:
        np.savez_compressed(
            args.save_problem, features=np.asarray(prob.features),
            labels=np.asarray(prob.labels), rho=np.float32(prob.rho),
            w_opt=np.asarray(prob.w_opt))
    tails = {}
    for sigma in SIGMAS:
        for scheme in list_mechanisms():
            t = repeat_tails(prob, scheme, sigma, args.iters, args.repeats)
            tails[(sigma, scheme)] = t
            print(json.dumps({"sigma": sigma, "scheme": scheme,
                              "tails": t}), flush=True)
    for (sigma, scheme), t in tails.items():
        pairs = [np.log((t[2 * j] + t[2 * j + 1]) / 2)
                 for j in range(args.repeats // 2)]
        print(json.dumps({
            "summary": True, "sigma": sigma, "scheme": scheme,
            "ref_tail": (t[0] + t[1]) / 2,
            "log_sd2": float(np.std(pairs, ddof=1)), "pairs": len(pairs),
            "log_mean": float(np.mean(np.log(t))),
            "log_sd": float(np.std(np.log(t), ddof=1)),
            "repeats": len(t)}), flush=True)


if __name__ == "__main__":
    main()
