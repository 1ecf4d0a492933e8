"""Theorem 2's privacy schedule (mirrors ``benchmarks/privacy_epsilon.py``):
(a) eps(i) = sqrt(2) mu B (1+i) i / sigma at a fixed sigma 0.2 (privacy
decays quadratically), and (b) the sigma that holds eps at 2 over growing
horizons (the utility cost of privacy, Theorem 1's O(mu) term).

    PYTHONPATH=src python -m repro_torch.launch.privacy_epsilon --device cpu

Pure accountant arithmetic, the same numbers as the reference's: the
device only names where an entry point of the port runs, and
``--reduced`` changes nothing.  Prints a ``# device`` line, CSV rows
``iteration,eps_at_sigma0.2,sigma_for_eps2`` (every digit of a float), and
two ``name,value`` lines.  Nothing is written to a file.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core.privacy.accountant import epsilon_at, sigma_for_epsilon
from repro_torch.launch.kernel_bench import device_name

HORIZONS = (1, 10, 50, 100, 500, 1000)


def run(mu: float = 0.1, B: float = 10.0):
    """(rows, summary): one row per horizon, and the quadratic-decay ratio
    eps(1000) / eps(100) with the sigma that eps 2 needs at 1000."""
    rows = [(i, epsilon_at(i, mu, B, sigma_g=0.2),
             sigma_for_epsilon(i, mu, B, eps=2.0)) for i in HORIZONS]
    return rows, [("privacy/eps_1000_over_eps_100", rows[-1][1] / rows[-3][1]),
                  ("privacy/sigma_for_eps2_at_1000", rows[-1][2])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="accepted for uniformity; the rows are the same")
    args = ap.parse_args(argv)
    print(f"# device: {device_name(resolve_device(args.device))}",
          flush=True)
    rows, summary = run()
    print("iteration,eps_at_sigma0.2,sigma_for_eps2")
    for i, eps, sig in rows:
        print(f"{i},{eps!r},{sig!r}")
    for name, val in summary:
        print(f"{name},{val!r}", flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
