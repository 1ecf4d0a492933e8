"""A plain GFL round (Rizk & Sayed 2021, eqs. 6-8, 23-24) and the draws it
runs on, written from the paper and the protocol's stated randomness.

One round at servers' parameters w [P, D]:

  (6)  w_pk = w_p - mu * clip_B(grad_pk)           clip_B(g) = g min(1, B/|g|)
  (7)  psi_p = (1/L) sum_k (w_pk + m_pk)           sum_k m_pk = 0 (eq. 23)
  (8)  w_p' = sum_m a_mp (psi_m + g_m) - g_p       g ~ Lap(sigma/sqrt 2) (eq. 24)

The pairwise masks m_pk cancel in the fold, so the reference leaves them
out.  A is the Metropolis matrix of the topology.  The protocol's draws are
a stated function of the run's seed: round i's stream s (0 the cohort, 1
the client level, 2 the combine) is a ``torch.Generator`` on the run's
device seeded with ``SeedSequence([seed, i, s])``; the cohort takes L
clients a server and B samples a client without replacement, as the
stable argsort of uniform keys; the combine noise is the inverse CDF of
uniforms in (-1/2 + 1e-7, 1/2 - 1e-7).  The reference draws them again
from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

COHORT, CLIENT, COMBINE = 0, 1, 2
U_LO, U_HI = -0.5 + 1e-7, 0.5 - 1e-7


def round_seed(seed: int, step: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def _gen(seed: int, step: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(round_seed(seed, step, stream))
    return gen


def cohort(seed: int, step: int, P: int, K: int, N: int, L: int, B: int,
           device):
    """(client_idx [P, L], batch_idx [P, L, B]) of round ``step``."""
    gen = _gen(seed, step, COHORT, device)
    keys = torch.rand((P, K), generator=gen, device=device)
    client_idx = torch.argsort(keys, dim=1, stable=True)[:, :L]
    keys = torch.rand((P, L, N), generator=gen, device=device)
    batch_idx = torch.argsort(keys, dim=2, stable=True)[..., :B]
    return client_idx, batch_idx


def combine_uniforms(seed: int, step: int, shape, device) -> torch.Tensor:
    """The combine stream's f32 uniforms in the open interval."""
    gen = _gen(seed, step, COMBINE, device)
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return u * (U_HI - U_LO) + U_LO


def laplace(u: torch.Tensor, sigma: float, dtype) -> torch.Tensor:
    """Lap(0, sigma / sqrt 2) (variance sigma^2) from uniforms u, taken in
    float64 or float32, whichever ``dtype`` allows, and given in
    ``dtype``: a narrower type would round the uniforms onto the interval's
    ends, where the inverse CDF is infinite."""
    u = u.to(torch.float64 if dtype == torch.float64 else torch.float32)
    b = sigma / np.sqrt(2.0)
    return (-b * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))).to(dtype)


def metropolis(topology: str, P: int) -> np.ndarray:
    """The doubly stochastic Metropolis weights of a ring or a full graph:
    a_pm = 1 / (1 + max(deg_p, deg_m)) on an edge, the rest on the diagonal."""
    adj = np.zeros((P, P), dtype=bool)
    if topology == "full":
        adj[:] = True
    elif topology == "ring":
        for p in range(P):
            adj[p, (p + 1) % P] = adj[p, (p - 1) % P] = True
    else:
        raise ValueError(f"no reference for topology {topology!r}")
    np.fill_diagonal(adj, False)
    deg = adj.sum(axis=1)
    A = np.zeros((P, P))
    for p in range(P):
        for m in range(P):
            if adj[p, m]:
                A[p, m] = 1.0 / (1.0 + max(deg[p], deg[m]))
        A[p, p] = 1.0 - A[p].sum()
    return A


def clip_coef(sq_norm: torch.Tensor, bound: float) -> torch.Tensor:
    """min(1, B / |g|) from squared norms."""
    return torch.clamp(bound / torch.clamp(torch.sqrt(sq_norm), min=1e-12),
                       max=1.0)


def combine(A: torch.Tensor, psi: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """Eq. 8 with eq.-24 noise: out_p = sum_m a_mp (psi_m + g_m) - g_p."""
    return A.T @ (psi + noise) - noise


# ------------------------------------------------------ Section V's rounds


def logistic_grads(w: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """Gradients of mean_b ln(1 + exp(-gamma h^T w)) + rho/2 |w|^2 at each
    server's w [P, M] for batches h [P, L, B, M], gamma [P, L, B]:
    [P, L, M]."""
    margins = gamma * (h * w[:, None, None, :]).sum(-1)
    coef = -gamma * torch.sigmoid(-margins)
    return (coef[..., None] * h).mean(-2) + rho * w[:, None, :]


def logistic_run(features: torch.Tensor, labels: torch.Tensor,
                 w_opt: torch.Tensor, proto: dict, seed: int, rounds: int,
                 dtype=torch.float64):
    """A run of ``rounds`` rounds from zero parameters, computed in
    ``dtype``: (final params [P, M], MSD of the centroid against w_opt
    after each round [rounds]), both float64 on the host.  ``proto``:
    P, K, N, L, B, mu, rho, bound, sigma, topology."""
    dev = features.device
    P, K, N, M = features.shape
    L, B = proto["L"], proto["B"]
    h_all, g_all = features.to(dtype), labels.to(dtype)
    A = torch.as_tensor(metropolis(proto["topology"], P), dtype=dtype,
                        device=dev)
    wo = w_opt.to(dtype)
    w = torch.zeros((P, M), dtype=dtype, device=dev)
    p_idx = torch.arange(P, device=dev)[:, None, None]
    msd = []
    for i in range(rounds):
        client_idx, batch_idx = cohort(seed, i, P, K, N, L, B, dev)
        h = h_all[p_idx, client_idx[:, :, None], batch_idx]
        gam = g_all[p_idx, client_idx[:, :, None], batch_idx]
        g = logistic_grads(w, h, gam, proto["rho"])
        c = clip_coef((g * g).sum(-1), proto["bound"])
        psi = (w[:, None, :] - proto["mu"] * c[..., None] * g).mean(1)
        noise = laplace(combine_uniforms(seed, i, (P, M), dev),
                        proto["sigma"], dtype)
        w = combine(A, psi, noise)
        msd.append(((w.mean(0) - wo) ** 2).sum())
    return (w.to(torch.float64).cpu(),
            torch.stack(msd).to(torch.float64).cpu())
