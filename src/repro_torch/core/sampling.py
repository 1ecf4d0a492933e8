"""Importance sampling of clients (Rizk, Vlaski & Sayed [22], [23]) — port
of ``repro.core.sampling``.

Clients are drawn with probabilities proportional to running estimates of
their gradient norms (updated whenever a client participates), floored for
exploration, and the aggregate is reweighted by 1/(K pi_k) so it stays
unbiased:

    pi_k  proportional to  max(||g_k|| estimate, floor)
    psi_p = w_p - mu * (1/L) sum_{k in L_p} g_k / (K pi_k)

The reference draws the cohort from a jax key; here
:func:`sample_clients` takes the uniforms instead (the run's ``cohort``
generator draws them, :meth:`repro_torch.draws.Draws.weighted_cohort`), so
a test can hand it the reference's own uniforms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ISState(NamedTuple):
    norm_est: torch.Tensor   # [P, K] f32 running gradient-norm estimates
    counts: torch.Tensor     # [P, K] int32 participation counts


def init_is_state(P: int, K: int, device=None) -> ISState:
    return ISState(torch.ones((P, K), dtype=torch.float32, device=device),
                   torch.zeros((P, K), dtype=torch.int32, device=device))


_EST_CAP = 1e6   # gradient-norm estimates above this are runaway values
                 # (clipped so a single inf/overflow cannot zero out every
                 # other client's probability)


def sampling_probs(state: ISState, floor: float = 0.1) -> torch.Tensor:
    """[P, K] client-sampling probabilities (each row sums to 1).

    NaN estimates take the unit prior, infs are clipped to ``_EST_CAP``,
    and the exploration floor is kept away from zero, so an all-zero row
    is the uniform distribution instead of 0/0."""
    est = torch.nan_to_num(state.norm_est, nan=1.0, posinf=_EST_CAP,
                           neginf=0.0)
    est = torch.clamp(est, 0.0, _EST_CAP)
    est = torch.maximum(est, torch.clamp(
        floor * est.mean(dim=1, keepdim=True), min=1e-12))
    return est / est.sum(dim=1, keepdim=True)


def sample_clients(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[P, L] client indices drawn WITH replacement per [23] (which keeps
    the importance weights unbiased), from uniforms ``u`` [P, L] in [0, 1).

    The inverse CDF of ``jax.random.choice(p=..., replace=True)``: r =
    cdf[-1] (1 - u), the first index whose cdf reaches r.  The CDF is
    summed in float64: at K = 10^5 a client's pi is about 1e-5 while the
    CDF near the middle is 0.5, where an f32 step is 6e-8, 0.6 % of that
    pi.  A client of probability 0 is never picked (its CDF step is empty
    and r > 0); the clamp keeps r's rounding inside [0, K)."""
    cdf = torch.cumsum(probs.to(torch.float64), dim=1)
    r = cdf[:, -1:] * (1.0 - u.to(torch.float64))
    idx = torch.searchsorted(cdf, r.contiguous())
    return torch.clamp(idx, max=probs.shape[1] - 1)


def importance_weights(probs: torch.Tensor, idx: torch.Tensor,
                       k_norm=None) -> torch.Tensor:
    """[P, L] unbiased reweighting 1/(K pi_k) of the sampled clients.

    ``k_norm`` (a number or [P]) replaces K: under an availability trace
    only K_avail clients can be drawn, and the unbiased target is the mean
    over the available ones,
    E[(1/L) sum_i g_{k_i} / (K_avail pi_{k_i})] = (1/K_avail) sum_avail g_k.
    """
    K = probs.shape[1] if k_norm is None else k_norm
    if isinstance(K, torch.Tensor) and K.dim() == 1:
        K = K.to(probs.dtype).reshape(-1, 1)
    pi = torch.gather(probs, 1, idx)
    return 1.0 / (K * torch.clamp(pi, min=1e-9))


def update_norm_estimates(state: ISState, idx: torch.Tensor,
                          grad_norms: torch.Tensor, decay: float = 0.7
                          ) -> ISState:
    """EMA-update the estimates of the clients that took part (idx [P, L],
    grad_norms [P, L]); counts add one per slot.

    Clients are drawn with replacement, so a row may name one client
    twice.  The reference's scatter keeps the LAST slot's value (XLA on
    the CPU); a CUDA scatter with repeated indices may keep any.  So every
    slot writes the value of the last slot naming its client ([P, L, L]
    compare), and the repeats write one value whatever their order."""
    est, cnt = state
    new = decay * torch.gather(est, 1, idx) + (1 - decay) * grad_norms
    L = idx.shape[1]
    slot = torch.arange(L, device=idx.device)
    same = idx[:, :, None] == idx[:, None, :]
    last = torch.where(same, slot, -1).amax(dim=2)
    est = est.scatter(1, idx, torch.gather(new, 1, last))
    cnt = cnt.scatter_add(1, idx, torch.ones_like(idx, dtype=cnt.dtype))
    return ISState(est, cnt)
