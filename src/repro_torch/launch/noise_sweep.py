"""Steady-state MSD against the noise level sigma_g for every registered
privacy mechanism (mirrors ``benchmarks/noise_sweep.py``).

    PYTHONPATH=src python -m repro_torch.launch.noise_sweep
    PYTHONPATH=src python -m repro_torch.launch.noise_sweep --reduced --device cpu

Shows Theorem 1's structure: iid-DP's MSD grows with O(mu + 1/mu) sigma^2,
while the hybrid family's (hybrid, gaussian_dp, scheduled) grows only with
the O(mu) network-disagreement term.  P=10, K=50, L=10, mu 0.1, B 10, full
topology, sigma in {0, 0.2, 0.5, 1, 2}, 250 iterations (``--reduced``:
100); ``scheduled`` gets the budget whose end-of-horizon sigma is the
sweep's.  The rounds run through the CUDA kernels (``use_kernels``).

Prints a ``# device`` line, CSV rows ``scheme,sigma_g,msd_tail`` and two
``name,value`` ratios to the non-private tail.  Nothing is written to a
file.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig
from repro_torch.core.privacy.accountant import scheduled_sigma_at
from repro_torch.core.privacy.mechanism import list_mechanisms
from repro_torch.core.simulate import generate_problem, msd_tail, run_gfl
from repro_torch.launch.kernel_bench import device_name

MU = 0.1
B = 10.0
SIGMAS = (0.0, 0.2, 0.5, 1.0, 2.0)


def run(iters: int = 250, reduced: bool = False, device=None):
    """(rows, summary) of the sweep."""
    if reduced:
        iters = 100
    prob = generate_problem(rng(0, device), P=10, K=50)
    rows, finals = [], {}
    for scheme in list_mechanisms():
        for sigma in SIGMAS if scheme != "none" else (0.0,):
            # scheduled ignores sigma_g: invert scheduled_sigma_at at
            # i == iters (sigma ~ 1/eps) so its end-of-horizon noise is
            # the sweep's
            eps = (scheduled_sigma_at(iters, MU, B, iters, 1.0) / sigma
                   if sigma > 0 else 0.0)
            cfg = GFLConfig(num_servers=10, clients_per_server=50,
                            clients_sampled=10, privacy=scheme,
                            sigma_g=sigma, mu=MU, topology="full",
                            grad_bound=B, epsilon_target=eps,
                            epsilon_horizon=iters, use_kernels=True)
            trace, _ = run_gfl(prob, cfg, iters=iters, batch_size=10, seed=1)
            tail = msd_tail(trace, iters)
            rows.append((scheme, sigma, tail))
            finals[(scheme, sigma)] = tail
    base = max(finals[("none", 0.0)], 1e-12)
    return rows, [
        ("noise_sweep/hybrid_over_none@sigma2", finals[("hybrid", 2.0)]
         / base),
        ("noise_sweep/iid_over_none@sigma2", finals[("iid_dp", 2.0)] / base),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="100 iterations")
    ap.add_argument("--iters", type=int, default=250)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows, summary = run(args.iters, args.reduced, dev)
    print("scheme,sigma_g,msd_tail")
    for scheme, sigma, tail in rows:
        print(f"{scheme},{sigma},{tail:.6g}")
    for name, val in summary:
        print(f"{name},{val:.6g}", flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
