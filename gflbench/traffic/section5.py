"""The Section V problem (Rizk & Sayed 2021), drawn from the run's seed.

Binary logistic regression on 2-D Gaussian data: gamma = +/-1 with equal
odds, h | gamma ~ N(gamma * 1, sigma_h^2 I) with one sigma_h a client drawn
uniformly from ``sigma_h_range``, ``N`` samples a client, ``K`` clients a
server, ``P`` servers.  The global minimizer w^o of the regularized risk
(the MSD's target) is solved by Newton's method in float64.

Everything is drawn on the device by one ``torch.Generator`` in a few large
calls, so a seed gives the same problem on every run.
"""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, purpose)."""
    state = np.random.SeedSequence([seed, purpose]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & ((1 << 63) - 1))
    return gen


def make_problem(seed: int, cfg: dict, device):
    """(features [P, K, N, M] f32, labels [P, K, N] f32, w_opt [M] f32) of
    the configuration ``cfg`` (keys P, K, N, M, rho, sigma_h_range)."""
    P, K, N, M = cfg["P"], cfg["K"], cfg["N"], cfg["M"]
    gen = generator(seed, 0, device)
    labels = torch.where(
        torch.rand((P, K, N), generator=gen, device=device) < 0.5, 1.0, -1.0)
    lo, hi = cfg["sigma_h_range"]
    sigma_h = lo + (hi - lo) * torch.rand((P, K, 1, 1), generator=gen,
                                          device=device)
    features = labels[..., None] + sigma_h * torch.randn(
        (P, K, N, M), generator=gen, device=device)
    w_opt = solve_global(features, labels, cfg["rho"])
    return features, labels, w_opt.to(torch.float32)


def solve_global(features: torch.Tensor, labels: torch.Tensor, rho: float,
                 iters: int = 30) -> torch.Tensor:
    """Newton's method in float64 on the strongly convex risk
    mean_n ln(1 + exp(-gamma h^T w)) + rho/2 ||w||^2; returns w^o [M]."""
    M = features.shape[-1]
    h = features.reshape(-1, M).to(torch.float64)
    g = labels.reshape(-1).to(torch.float64)
    w = torch.zeros(M, dtype=torch.float64, device=h.device)
    eye = torch.eye(M, dtype=torch.float64, device=h.device)
    for _ in range(iters):
        s = torch.sigmoid(-g * (h @ w))
        grad = -(g * s) @ h / h.shape[0] + rho * w
        hess = (h * (s * (1 - s))[:, None]).T @ h / h.shape[0] + rho * eye
        w = w - torch.linalg.solve(hess, grad)
    return w
