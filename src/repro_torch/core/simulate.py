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
from repro_torch.core.topology import combination_matrix, spectral_gap


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


def global_risk(w: torch.Tensor, prob: LogisticProblem) -> torch.Tensor:
    """The regularized logistic risk of ``w`` over every sample."""
    h = prob.features.reshape(-1, prob.features.shape[-1])
    g = prob.labels.reshape(-1)
    return logistic_loss(w, h, g, prob.rho)


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
    """Per-client gradients of Q: (params [P, D], or one model a client
    [P, L, D] as the event engine's stale snapshots, (h [P, L, B, M],
    gamma [P, L, B])) -> [P, L, D]."""
    def grad_fn(params, batch):
        h, gamma = batch
        w = params[:, None, :] if params.dim() == 2 else params
        return _logistic_grad(w, h, gamma, rho)
    return grad_fn


def sample_round_batches(draws, step: int, prob: LogisticProblem, L: int,
                         batch_size: int):
    """Sample L participating clients per server and a minibatch each, from
    round ``step``'s ``cohort`` draw: (h [P, L, B, M], gamma [P, L, B]).
    The population engine's cohort draw over a dense population — the
    program the engine runs, as in the reference."""
    from repro_torch.core.population import (DensePopulation,
                                             uniform_cohort_batch)
    return uniform_cohort_batch(draws, step,
                                DensePopulation.from_problem(prob), L,
                                batch_size)


def base_combination_matrix(cfg: GFLConfig, P: int) -> np.ndarray:
    """The config's base A (topology family + seed/rows knobs applied)."""
    return combination_matrix(cfg.topology, P, rows=cfg.torus_rows,
                              seed=cfg.topology_seed)


def run_gfl(prob: LogisticProblem, cfg: GFLConfig, *, iters: int,
            batch_size: int = 10, seed: int = 0, record_every: int = 1,
            A: np.ndarray | None = None, process=None,
            record_gaps: bool = False, draws=None, executor=None):
    """Run the protocol on the problem's device; return (msd_trace [T],
    final params [P, D]), and with ``record_gaps`` the per-round
    ``spectral_gap(A_i)`` [iters] third.

    ``cfg.fault != "none"`` (or an explicit ``process``, a
    :class:`~repro_torch.core.resilience.process.TopologyProcess`) runs the
    resilience runtime: per-round A_i, client dropout, stragglers.  This
    IS the population engine's pure path over a dense population.
    ``draws`` replaces the run's generators (``Draws(seed)``) with, e.g.,
    a replay of the reference's draws.  ``executor``: the round graph
    (``"graph"``, the default on a card) or ``"eager"`` (see
    :func:`~repro_torch.core.population.engine.run_gfl_population`)."""
    from repro_torch.core.population import CohortScheduler, DensePopulation
    from repro_torch.core.population.engine import run_gfl_population

    pop = DensePopulation.from_problem(prob)
    scheduler = CohortScheduler(pop.num_clients, cfg.effective_clients,
                                pop.P)
    res = run_gfl_population(pop, cfg, iters=iters, batch_size=batch_size,
                             seed=seed, record_every=record_every, A=A,
                             process=process, scheduler=scheduler,
                             draws=draws, executor=executor)
    if not record_gaps:
        return res.msd, res.params
    gaps = res.gaps
    if gaps is None:
        base = A if A is not None else base_combination_matrix(cfg, pop.P)
        gaps = np.full(iters, spectral_gap(np.asarray(base)))
    return res.msd, res.params, gaps


def run_gfl_importance(prob: LogisticProblem, cfg: GFLConfig, *, iters: int,
                       batch_size: int = 10, seed: int = 0, draws=None,
                       executor=None):
    """GFL with importance-sampled clients ([22], [23]): clients drawn with
    probability proportional to their running gradient-norm estimates,
    updates reweighted by 1/(K pi_k) to stay unbiased.  Returns (msd
    trace, final params).  The population engine's weighted round over
    the dense problem with an ``importance`` cohort (one implementation,
    as in the reference)."""
    from dataclasses import replace

    from repro_torch.core.population import run_gfl_population

    res = run_gfl_population(prob, replace(cfg, cohort="importance"),
                             iters=iters, batch_size=batch_size, seed=seed,
                             draws=draws, executor=executor)
    return res.msd, res.params


def run_schemes(seed: int = 0, *, iters: int = 500, sigma_g: float = 0.2,
                P: int = 10, K: int = 50, L: int = 0, mu: float = 0.1,
                repeats: int = 3, topology: str = "full",
                batch_size: int = 10, grad_bound: float = 10.0,
                schemes: tuple | None = None,
                epsilon_target: float | None = None,
                fault: str = "none", topology_seed: int = 0,
                use_kernels: bool = False, device=None,
                problem: LogisticProblem | None = None):
    """Fig. 2 harness: every registered privacy mechanism on the same
    problem, ``repeats`` runs each (seeds 1000, 1001, ...), returning
    (problem, {scheme: the repeats' mean MSD trace}).  ``scheduled``
    spends the budget the fixed-sigma Theorem-2 curve spends by ``iters``,
    so its row is noise-comparable to hybrid's.  ``fault`` runs every
    scheme under the same fault realizations; ``use_kernels`` runs the
    rounds through the CUDA kernels (the reference leaves its own off).
    ``problem`` (for example the reference's, converted) replaces the one
    drawn from ``seed``; P and K are then its own."""
    from repro_torch import rng
    from repro_torch.core.privacy.accountant import epsilon_at
    from repro_torch.core.privacy.mechanism import list_mechanisms

    device = resolve_device(device)
    if epsilon_target is None:
        epsilon_target = (epsilon_at(iters, mu, grad_bound, sigma_g)
                          if sigma_g > 0 else 0.0)
    prob = (problem if problem is not None
            else generate_problem(rng(seed, device), P=P, K=K))
    P, K = prob.labels.shape[:2]
    out = {}
    for scheme in schemes if schemes is not None else list_mechanisms():
        cfg = GFLConfig(num_servers=P, clients_per_server=K,
                        clients_sampled=L, topology=topology,
                        privacy=scheme, sigma_g=sigma_g, mu=mu,
                        grad_bound=grad_bound, fault=fault,
                        topology_seed=topology_seed,
                        epsilon_target=epsilon_target, epsilon_horizon=iters,
                        use_kernels=use_kernels)
        traces = [run_gfl(prob, cfg, iters=iters, batch_size=batch_size,
                          seed=1000 + r)[0] for r in range(repeats)]
        out[scheme] = np.mean(np.stack(traces), axis=0)
    return prob, out


def msd_tail(msd: np.ndarray, iters: int) -> float:
    """The steady-state MSD the benchmarks report: the mean over the last
    ``max(iters // 10, 5)`` rounds."""
    return float(np.mean(msd[-max(iters // 10, 5):]))


def fault_sweep(prob: LogisticProblem, cfg: GFLConfig, *, iters: int,
                drop_probs, fault_kind: str = "links",
                batch_size: int = 10, seed: int = 0):
    """MSD against failure rate: ``cfg`` under ``<fault_kind>:<p>`` for each
    p in ``drop_probs``.  Returns rows ``(p, msd_tail, gap_mean,
    gap_worst)`` — the realized spectral-gap trajectory (larger = slower
    mixing) connects the failure rate to the convergence hit."""
    from dataclasses import replace

    rows = []
    for p in drop_probs:
        spec = "none" if p == 0 else f"{fault_kind}:{p:g}"
        msd, _, gaps = run_gfl(prob, replace(cfg, fault=spec), iters=iters,
                               batch_size=batch_size, seed=seed,
                               record_gaps=True)
        rows.append((float(p), msd_tail(msd, iters), float(gaps.mean()),
                     float(gaps.max())))
    return rows
