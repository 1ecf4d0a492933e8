"""Paper-scale GFL simulator: the Section V experiment (Fig. 2) — port of
``repro.core.simulate``.

P = 10 servers x K = 50 clients, binary logistic regression on synthetic
2-D Gaussian data: gamma = +/-1, h | gamma ~ N(gamma * 1, sigma_h^2 I),
N = 100 samples per client, loss

    Q(w; h, gamma) = ln(1 + exp(-gamma h^T w)) + rho/2 ||w||^2.

The metric is the mean-square deviation of the network centroid,
MSD_i = ||w_c,i - w^o||^2.  Gradients are the closed form of that loss,
batched over servers and clients, where the reference takes ``jax.grad``
under two ``vmap``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core.topology import combination_matrix


@dataclass(frozen=True)
class LogisticProblem:
    features: torch.Tensor   # [P, K, N, M]
    labels: torch.Tensor     # [P, K, N]
    rho: float
    w_opt: torch.Tensor      # [M] global minimizer


def generate_problem(generator: torch.Generator, P: int = 10, K: int = 50,
                     N: int = 100, M: int = 2, rho: float = 0.01,
                     sigma_h_range=(0.5, 1.5)) -> LogisticProblem:
    """Synthetic data as in Section V (heterogeneous sigma_h per client),
    drawn on the generator's device."""
    dev = generator.device
    labels = torch.where(
        torch.rand((P, K, N), generator=generator, device=dev) < 0.5,
        1.0, -1.0)
    lo, hi = sigma_h_range
    sigma_h = lo + (hi - lo) * torch.rand((P, K, 1, 1), generator=generator,
                                          device=dev)
    noise = torch.randn((P, K, N, M), generator=generator,
                        device=dev) * sigma_h
    features = labels[..., None] + noise
    w_opt = _solve_global(features, labels, rho)
    return LogisticProblem(features, labels, rho, w_opt)


def logistic_loss(w: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                  rho: float) -> torch.Tensor:
    """Mean regularized logistic loss over a batch. h: [..., M], gamma: [...]."""
    margins = gamma * (h * w).sum(dim=-1)
    return (torch.logaddexp(torch.zeros_like(margins), -margins).mean()
            + 0.5 * rho * (w * w).sum())


def _logistic_grad(w: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """grad of the mean logistic loss over the sample axis (-2 of h).
    w: [..., M] broadcast against h [..., S, M], gamma [..., S]."""
    margins = gamma * (h * w[..., None, :]).sum(dim=-1)
    coef = -gamma * torch.sigmoid(-margins)             # d loss / d margin
    return (coef[..., None] * h).mean(dim=-2) + rho * w


def _solve_global(features: torch.Tensor, labels: torch.Tensor, rho: float,
                  iters: int = 4000, lr: float = 1.0) -> torch.Tensor:
    """Full-batch GD to machine precision on the strongly-convex global
    risk, on the data's device."""
    M = features.shape[-1]
    h = features.reshape(-1, M).to(torch.float32)
    g = labels.reshape(-1).to(torch.float32)
    w = torch.zeros(M, dtype=torch.float32, device=features.device)
    for _ in range(iters):
        w = w - lr * _logistic_grad(w, h, g, rho)
    return w


def make_grad_fn(rho: float) -> Callable:
    """Per-client gradients of Q: (params [P, D], (h [P, L, B, M],
    gamma [P, L, B])) -> [P, L, D]."""
    def grad_fn(params, batch):
        h, gamma = batch
        return _logistic_grad(params[:, None, :], h, gamma, rho)
    return grad_fn


def base_combination_matrix(cfg: GFLConfig, P: int) -> np.ndarray:
    """The config's base A (topology family + seed/rows knobs applied)."""
    return combination_matrix(cfg.topology, P, rows=cfg.torus_rows,
                              seed=cfg.topology_seed)


def run_gfl(prob: LogisticProblem, cfg: GFLConfig, *, iters: int,
            batch_size: int = 10, seed: int = 0, record_every: int = 1,
            A: np.ndarray | None = None, draws=None):
    """Run the protocol on the problem's device; return (msd_trace [T],
    final params [P, D]).

    This IS the population engine's pure path over a dense population.
    ``draws`` replaces the run's generators (``Draws(seed)``) with, e.g.,
    a replay of the reference's draws."""
    from repro_torch.core.population import CohortScheduler, DensePopulation
    from repro_torch.core.population.engine import run_gfl_population

    pop = DensePopulation.from_problem(prob)
    scheduler = CohortScheduler(pop.num_clients, cfg.effective_clients,
                                pop.P)
    res = run_gfl_population(pop, cfg, iters=iters, batch_size=batch_size,
                             seed=seed, record_every=record_every, A=A,
                             scheduler=scheduler, draws=draws)
    return res.msd, res.params


def run_schemes(seed: int = 0, *, iters: int = 500, sigma_g: float = 0.2,
                P: int = 10, K: int = 50, L: int = 0, mu: float = 0.1,
                repeats: int = 3, topology: str = "full",
                batch_size: int = 10, grad_bound: float = 10.0,
                schemes: tuple | None = None,
                epsilon_target: float | None = None, device=None):
    """Fig. 2 harness: every registered privacy mechanism on the same
    problem.  ``scheduled`` spends the budget the fixed-sigma Theorem-2
    curve spends by ``iters``, so its row is noise-comparable to hybrid's."""
    from repro_torch import rng
    from repro_torch.core.privacy.accountant import epsilon_at
    from repro_torch.core.privacy.mechanism import list_mechanisms

    device = resolve_device(device)
    if epsilon_target is None:
        epsilon_target = (epsilon_at(iters, mu, grad_bound, sigma_g)
                          if sigma_g > 0 else 0.0)
    prob = generate_problem(rng(seed, device), P=P, K=K)
    out = {}
    for scheme in schemes if schemes is not None else list_mechanisms():
        cfg = GFLConfig(num_servers=P, clients_per_server=K,
                        clients_sampled=L, topology=topology,
                        privacy=scheme, sigma_g=sigma_g, mu=mu,
                        grad_bound=grad_bound,
                        epsilon_target=epsilon_target, epsilon_horizon=iters)
        traces = [run_gfl(prob, cfg, iters=iters, batch_size=batch_size,
                          seed=1000 + r)[0] for r in range(repeats)]
        out[scheme] = np.mean(np.stack(traces), axis=0)
    return prob, out
