"""Quickstart of the port: the paper's Section-V experiment on the card.

Runs graph federated learning (P=10 servers x K=50 clients, logistic
regression) under every registered privacy mechanism with the CUDA
kernels on (``use_kernels=True``), and prints the steady-state MSD and the
privacy ledger — the qualitative Figure-2 result: hybrid tracks the
non-private run, iid-DP costs utility.  Mirrors ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig
from repro_torch.core.privacy.accountant import PrivacyAccountant, epsilon_at
from repro_torch.core.privacy.mechanism import list_mechanisms, mechanism_for
from repro_torch.core.simulate import generate_problem, run_gfl

ITERS = 200
SIGMA = 0.2
MU = 0.1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters

    print(f"generating the paper's synthetic logistic problem "
          f"(P=10, K=50, M=2) on {device}...")
    prob = generate_problem(rng(0, device), P=10, K=50, N=100, M=2)
    print(f"  global optimum w* = {prob.w_opt.cpu().numpy().round(3)}")

    # scheduled gets the budget the fixed-sigma run spends by the horizon
    eps_budget = epsilon_at(iters, MU, 10.0, SIGMA)
    for scheme in list_mechanisms():
        cfg = GFLConfig(num_servers=10, clients_per_server=50,
                        clients_sampled=10, privacy=scheme, sigma_g=SIGMA,
                        mu=MU, topology="full", grad_bound=10.0,
                        epsilon_target=eps_budget, epsilon_horizon=iters,
                        use_kernels=True)
        msd, _ = run_gfl(prob, cfg, iters=iters, batch_size=10, seed=1)
        tail = float(np.mean(msd[-20:]))
        acc = mechanism_for(cfg).accountant()
        acc.advance(iters)
        print(f"  scheme={scheme:12s}  MSD[0]={msd[0]:.3f}  "
              f"MSD[final]={tail:.5f}  eps({iters})={acc.epsilon():.1f}")

    acc = PrivacyAccountant(mu=MU, grad_bound=10.0, sigma_g=SIGMA)
    acc.advance(iters)
    print(f"privacy ledger after {iters} iterations: "
          f"eps({iters}) = {acc.epsilon():.1f} "
          f"(Theorem 2; privacy decays quadratically with time)")
    print(f"sigma needed for eps=5 at this horizon: "
          f"{acc.sigma_schedule(iters, 5.0):.2f}")


if __name__ == "__main__":
    main()
