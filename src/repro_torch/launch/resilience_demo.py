"""The paper's robustness claim, run (mirrors
``examples/resilience_demo.py``): the Section-V logistic problem under
failure regimes of rising hostility — link drops, correlated server
outages, stragglers re-announcing stale psi, mid-round client dropout
with dropout-safe secure aggregation — with, per regime, the steady-state
MSD and the realized spectral-gap trajectory (lambda_i = rho(A_i -
11^T/P): 0 mixes at once, 1 never).

    PYTHONPATH=src python -m repro_torch.launch.resilience_demo
    PYTHONPATH=src python -m repro_torch.launch.resilience_demo --reduced --device cpu

P=8 servers, K=20 clients, L=5, hypercube, hybrid, sigma 0.2, mu 0.1, B
10, topology seed 7, 150 iterations (``--reduced``: 30).  The rounds run
through the CUDA kernels (``use_kernels``).  Every realized A_i is
symmetric, doubly stochastic and connected (Assumption 1).

Prints a ``# device`` line, CSV rows ``regime,fault_spec,msd_tail,
gap_mean,gap_worst`` (a spec with a comma quoted) and a ``#`` line describing round 0's realization
under links:0.3.  Nothing is written to a file.
"""
from __future__ import annotations

import argparse
import csv
import sys

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig
from repro_torch.core.resilience import TopologyProcess, parse_fault_spec
from repro_torch.core.simulate import (
    base_combination_matrix,
    generate_problem,
    msd_tail,
    run_gfl,
)
from repro_torch.core.topology import spectral_gap
from repro_torch.launch.kernel_bench import device_name

ITERS = 150

REGIMES = (
    ("failure-free", "none"),
    ("flaky links", "links:0.2"),
    ("links + outages", "links:0.1+outage:0.1"),
    ("stragglers (stale<=3)", "straggler:0.3,stale=3"),
    ("client dropout 30%", "dropout:0.3"),
    ("everything at once",
     "links:0.1+outage:0.05+straggler:0.2,stale=2+dropout:0.2"),
)


def run(iters: int = ITERS, reduced: bool = False, device=None):
    """Rows (regime, spec, msd_tail, gap_mean, gap_worst)."""
    if reduced:
        iters = 30
    prob = generate_problem(rng(0, device), P=8, K=20)
    rows = []
    for name, spec in REGIMES:
        cfg = GFLConfig(num_servers=8, clients_per_server=20,
                        clients_sampled=5, topology="hypercube",
                        privacy="hybrid", sigma_g=0.2, mu=0.1,
                        grad_bound=10.0, fault=spec, topology_seed=7,
                        use_kernels=True)
        msd, _, gaps = run_gfl(prob, cfg, iters=iters, batch_size=10,
                               seed=1, record_gaps=True)
        rows.append((name, spec, msd_tail(msd, iters), float(gaps.mean()),
                     float(gaps.max())))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="30 iterations")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows = run(args.iters, args.reduced, dev)
    out = csv.writer(sys.stdout, lineterminator="\n")
    out.writerow(["regime", "fault_spec", "msd_tail", "gap_mean",
                  "gap_worst"])
    for name, spec, tail, gm, gw in rows:
        out.writerow([name, spec, f"{tail:.6g}", f"{gm:.6g}", f"{gw:.6g}"])
    fault = parse_fault_spec("links:0.3")
    proc = TopologyProcess(
        base_combination_matrix(GFLConfig(topology="hypercube"), 8), fault,
        seed=7)
    real = proc.realize(0)
    dropped = int((proc.base_mask & ~real.link_mask).sum() // 2)
    total = int(proc.base_mask.sum() // 2)
    print(f"# round 0 under {fault.to_spec()}: {dropped} of {total} links "
          f"down, spectral gap {real.gap:.3f} "
          f"(base {spectral_gap(proc.base_A):.3f})")
    return rows


if __name__ == "__main__":
    main()
