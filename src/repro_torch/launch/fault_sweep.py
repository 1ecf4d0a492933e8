"""MSD against failure rate per topology family (mirrors
``benchmarks/fault_sweep.py``), with the cost of a faulted round.

    PYTHONPATH=src python -m repro_torch.launch.fault_sweep
    PYTHONPATH=src python -m repro_torch.launch.fault_sweep --reduced --device cpu

For each topology (ring, torus, hypercube, full) and fault kind (links,
outage) and probability p in {0, 0.05, 0.1, 0.2, 0.3, 0.5}, runs hybrid
GFL (P=8, K=20, L=5, sigma 0.2, mu 0.1, B 10, 300 iterations) under the
resilience runtime: per-round A_i with Metropolis fold-back, Assumption 1
held every round.  ``--reduced``: 60 iterations, K=10, links only, p in
{0, 0.1, 0.3}.  The rounds run through the CUDA kernels (``use_kernels``).

Prints a ``# device`` line, CSV rows ``topology,fault_kind,drop_p,
msd_tail,gap_mean,gap_worst,wall_ms_per_round`` (p = 0 is the static
path), then ``name,value`` lines: per topology the MSD ratio and gap
change at the largest p; the mean wall ms a round of the static and the
faulted runs; and the host ms a round that realizing A_i takes
(``TopologyProcess.realize`` on a fresh process: fold-back, union-find and
the eigendecomposition for the gap) with its share of a faulted round.
Times are host-clock, around work that ends in a copy to the host.
Nothing is written to a file.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device, rng
from repro_torch.configs.base import GFLConfig
from repro_torch.core.resilience import TopologyProcess
from repro_torch.core.simulate import (
    base_combination_matrix,
    fault_sweep,
    generate_problem,
)
from repro_torch.launch.kernel_bench import device_name

TOPOLOGIES = ("ring", "torus", "hypercube", "full")
FAULT_KINDS = ("links", "outage")


def realize_ms(cfg: GFLConfig, P: int, spec: str, rounds: int) -> float:
    """Host ms a round to realize A_i (and the survivor mask) afresh."""
    proc = TopologyProcess(base_combination_matrix(cfg, P), spec,
                           seed=cfg.topology_seed)
    t0 = time.perf_counter()
    for i in range(rounds):
        proc.realize(i)
        proc.client_alive(i, cfg.effective_clients)
    return (time.perf_counter() - t0) * 1e3 / rounds


def run(iters: int = 300, reduced: bool = False, P: int = 8, K: int = 20,
        sigma_g: float = 0.2, device=None):
    """(rows, summary) of the sweep."""
    if reduced:
        iters, K = 60, 10
    drop_ps = (0.0, 0.1, 0.3) if reduced else (0.0, 0.05, 0.1, 0.2, 0.3,
                                                 0.5)
    kinds = ("links",) if reduced else FAULT_KINDS
    prob = generate_problem(rng(0, device), P=P, K=K)
    rows, finals, walls, hosts = [], {}, {True: [], False: []}, []
    for topology in TOPOLOGIES:
        cfg = GFLConfig(num_servers=P, clients_per_server=K,
                        clients_sampled=min(5, K), topology=topology,
                        privacy="hybrid", sigma_g=sigma_g, mu=0.1,
                        grad_bound=10.0, use_kernels=True)
        for kind in kinds:
            for p in drop_ps:
                t0 = time.perf_counter()
                [(_, tail, gap_mean, gap_worst)] = fault_sweep(
                    prob, cfg, iters=iters, drop_probs=(p,),
                    fault_kind=kind, batch_size=10, seed=1)
                wall = (time.perf_counter() - t0) * 1e3 / iters
                walls[p > 0].append(wall)
                if p > 0:
                    hosts.append(realize_ms(cfg, P, f"{kind}:{p:g}", iters))
                rows.append((topology, kind, p, tail, gap_mean, gap_worst,
                             wall))
                finals[(topology, kind, p)] = (tail, gap_mean)
    p_hi = max(drop_ps)
    summary = []
    for topology in TOPOLOGIES:
        base_msd, base_gap = finals[(topology, "links", 0.0)]
        hi_msd, hi_gap = finals[(topology, "links", p_hi)]
        summary.append((f"fault_sweep/{topology}_msd_ratio@p{p_hi:g}",
                        hi_msd / max(base_msd, 1e-12)))
        summary.append((f"fault_sweep/{topology}_gap_delta@p{p_hi:g}",
                        hi_gap - base_gap))
    static = sum(walls[False]) / len(walls[False])
    faulted = sum(walls[True]) / len(walls[True])
    host = sum(hosts) / len(hosts)
    summary += [("fault_sweep/wall_ms_per_round/static", static),
                ("fault_sweep/wall_ms_per_round/faulted", faulted),
                ("fault_sweep/host_realize_ms_per_round", host),
                ("fault_sweep/host_realize_share_of_faulted_round",
                 host / faulted)]
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="60 iterations, K=10, links at p 0, 0.1, 0.3")
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# device: {device_name(dev)}", flush=True)
    rows, summary = run(args.iters, args.reduced, device=dev)
    print("topology,fault_kind,drop_p,msd_tail,gap_mean,gap_worst,"
          "wall_ms_per_round")
    for topology, kind, p, tail, gm, gw, wall in rows:
        print(f"{topology},{kind},{p:g},{tail:.6g},{gm:.6g},{gw:.6g},"
              f"{wall:.6g}")
    for name, val in summary:
        print(f"{name},{val:.6g}", flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
