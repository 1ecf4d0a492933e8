"""Privacy-utility trade-off (mirrors ``examples/dp_sweep.py``): for each
target epsilon, each mechanism's accountant curve sets its noise, and the
steady-state MSD measures the utility it leaves.

    PYTHONPATH=src python -m repro_torch.launch.dp_sweep
    PYTHONPATH=src python -m repro_torch.launch.dp_sweep --reduced --device cpu

hybrid, gaussian_dp and iid_dp run at the fixed sigma their own curve
demands for the target at the horizon (Theorem 2 / the Gaussian
mechanism); ``scheduled`` spends the budget round by round through
``epsilon_target``.  P=10, K=50, L=10, mu 0.1, B 10, full topology, 150
iterations at eps 1000, 5000 and 20000 (``--reduced``: 30 iterations at
eps 1000).  The rounds run through the CUDA kernels (``use_kernels``).

Prints a ``# device`` line, CSV rows ``eps_target,scheme,sigma_g,msd_tail``
(scheduled's sigma_g is its end-of-horizon sigma) and one
``scheduled:gaussian_dp`` profile line.  Nothing is written to a file.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig
from repro_torch.core.privacy.mechanism import get_mechanism, mechanism_for
from repro_torch.core.simulate import generate_problem, msd_tail, run_gfl
from repro_torch.launch.kernel_bench import device_name

ITERS = 150
MU = 0.1
B = 10.0
EPSILONS = (1000.0, 5000.0, 20000.0)
SCHEMES = ("hybrid", "gaussian_dp", "iid_dp", "scheduled")


def run(iters: int = ITERS, reduced: bool = False, device=None):
    """Rows (eps_target, scheme, sigma_g, msd_tail)."""
    epsilons = EPSILONS
    if reduced:
        iters, epsilons = 30, EPSILONS[:1]
    prob = generate_problem(rng(0, device), P=10, K=50)
    rows = []
    for eps in epsilons:
        for scheme in SCHEMES:
            cfg = GFLConfig(num_servers=10, clients_per_server=50,
                            clients_sampled=10, privacy=scheme,
                            sigma_g=0.0, mu=MU, topology="full",
                            grad_bound=B, epsilon_target=eps,
                            epsilon_horizon=iters, use_kernels=True)
            mech = mechanism_for(cfg)
            if scheme == "scheduled":
                sigma = mech.noise_profile().server_sigma
            else:
                # fixed sigma from the mechanism's own accountant curve
                sigma = mech.accountant().sigma_schedule(iters, eps)
                cfg = dataclasses.replace(cfg, sigma_g=sigma)
            msd, _ = run_gfl(prob, cfg, iters=iters, batch_size=10, seed=2)
            rows.append((eps, scheme, float(sigma), msd_tail(msd, iters)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="30 iterations, eps 1000 only")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows = run(args.iters, args.reduced, dev)
    print("eps_target,scheme,sigma_g,msd_tail")
    for eps, scheme, sigma, tail in rows:
        print(f"{eps:g},{scheme},{sigma:.6g},{tail:.6g}", flush=True)
    cfg = GFLConfig(privacy="scheduled:gaussian_dp", epsilon_target=1000.0,
                    epsilon_horizon=args.iters, mu=MU, grad_bound=B)
    prof = get_mechanism(cfg.privacy, cfg).noise_profile()
    print(f"# scheduled:gaussian_dp profile: curve={prof.curve} "
          f"distribution={prof.distribution} "
          f"sigma@horizon={prof.server_sigma:.2f}")
    return rows


if __name__ == "__main__":
    main()
