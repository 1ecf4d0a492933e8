"""The paper's Figure 2 (mirrors ``benchmarks/fig2_convergence.py``): MSD of
the network centroid against iteration for every registered privacy
mechanism, at the paper's noise level (sigma 0.2) and at 1.0, where iid-DP
degrades and the hybrid scheme does not.

    PYTHONPATH=src python -m repro_torch.launch.fig2_convergence
    PYTHONPATH=src python -m repro_torch.launch.fig2_convergence --reduced --device cpu

The paper's setting: P=10 servers, K=50 clients, L=10 sampled, M=2
logistic regression, mu 0.1, rho 0.01, full topology, 400 iterations, 2
repeats (``--reduced``: 120 iterations, 1 repeat).  The rounds run through
the CUDA kernels (``use_kernels``).  The problem is drawn from seed 0, or
read from ``--problem FILE``, an ``.npz`` of features, labels, rho and
w_opt such as ``fig2_reference.py --save-problem`` writes of the
reference's own (``data/fig2_problem0.npz``), so the two packages' tails
can be held against each other on one problem.

Prints a ``# device`` line, then CSV rows ``sigma_g,scheme,iter,msd`` of
the repeat-mean trace every ``--every`` iterations (and the last), then
``fig2_msd_tail/sigma=<s>/<scheme>,<tail>`` lines: the mean MSD over the
last max(iters/10, 5) iterations.  Nothing is written to a file.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.convert import problem_from_numpy
from repro_torch.core.simulate import LogisticProblem, msd_tail, run_schemes
from repro_torch.launch.kernel_bench import device_name

SIGMAS = (0.2, 1.0)


def load_problem(path, device=None) -> LogisticProblem:
    """The problem of an ``.npz`` of features, labels, rho and w_opt."""
    with np.load(path) as z:
        return problem_from_numpy(z["features"], z["labels"], float(z["rho"]),
                                  z["w_opt"], device=device)


def run(iters: int = 400, repeats: int = 2, reduced: bool = False,
        device=None, problem: LogisticProblem | None = None):
    """(trace rows, summary rows) of the experiment."""
    if reduced:
        iters, repeats = 120, 1
    rows, summary = [], []
    for sigma in SIGMAS:
        _, msd = run_schemes(0, iters=iters, sigma_g=sigma, P=10, K=50,
                             L=10, mu=0.1, repeats=repeats, topology="full",
                             use_kernels=True, device=device,
                             problem=problem)
        for scheme, trace in msd.items():
            rows += [(sigma, scheme, i, float(v))
                     for i, v in enumerate(trace)]
            summary.append((f"fig2_msd_tail/sigma={sigma}/{scheme}",
                            msd_tail(trace, iters)))
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="120 iterations, 1 repeat")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--every", type=int, default=10,
                    help="print every n-th trace row (and the last)")
    ap.add_argument("--problem", default=None,
                    help=".npz of the problem (default: drawn from seed 0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    prob = load_problem(args.problem, dev) if args.problem else None
    rows, summary = run(args.iters, args.repeats, args.reduced, dev, prob)
    last = max(i for _, _, i, _ in rows)
    print("sigma_g,scheme,iter,msd")
    for sigma, scheme, i, v in rows:
        if i % args.every == 0 or i == last:
            print(f"{sigma},{scheme},{i},{v:.6g}")
    for name, val in summary:
        print(f"{name},{val:.6g}", flush=True)
    return summary


if __name__ == "__main__":
    main()
