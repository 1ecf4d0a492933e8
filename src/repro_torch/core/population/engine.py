"""Population executor, pure path (port of
``repro.core.population.engine``).

The pure path is the dense simulator's loop: each round draws the cohort
(L clients per server without replacement, B samples each), gathers its
minibatches and takes one :func:`~repro_torch.core.gfl.make_gfl_step`
step.  The reference syncs the MSD to the host every round; the port keeps
the per-round MSD on the device and copies the trace once per run.
``scan=True`` — in the reference one ``lax.scan`` over the whole run — is
the same loop here, recording every round.

Not in this slice (they raise ``NotImplementedError`` naming their
ROADMAP slice): the weighted path (importance sampling, availability
traces), lazy populations, fault processes, telemetry and the sanitizer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core import gfl
from repro_torch.core.population.cohort import CohortScheduler
from repro_torch.core.population.population import (
    ClientPopulation,
    DensePopulation,
)
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.simulate import base_combination_matrix, make_grad_fn
from repro_torch.draws import Draws


def uniform_cohort_indices(draws, step: int, P: int, K: int, N: int, L: int,
                           batch_size: int):
    """The dense simulator's cohort index draw: (client_idx [P, L],
    batch_idx [P, L, B])."""
    return draws.cohort(step, P, K, N, L, batch_size)


def uniform_cohort_batch(draws, step: int, pop: ClientPopulation, L: int,
                         batch_size: int):
    """The dense simulator's cohort draw over a population: (h [P, L, B, M],
    gamma [P, L, B])."""
    client_idx, batch_idx = uniform_cohort_indices(
        draws, step, pop.P, pop.num_clients, pop.samples_per_client, L,
        batch_size)
    return pop.gather(client_idx, batch_idx)


def as_population(source) -> ClientPopulation:
    if isinstance(source, ClientPopulation):
        return source
    if hasattr(source, "features") and hasattr(source, "labels"):
        return DensePopulation.from_problem(source)
    raise NotImplementedError(
        f"population source {type(source).__name__}: only a materialized "
        "problem or a DensePopulation is ported (lazy populations: ROADMAP "
        "slice 3)")


class PopulationRunResult(NamedTuple):
    """Trajectory of one population-engine run."""
    msd: np.ndarray            # centroid MSD vs w_ref, every record_every
    params: torch.Tensor       # final [P, D] per-server models
    q: np.ndarray              # realized per-round sampling rate
    scheduler: CohortScheduler
    accountant: Optional[object] = None   # PrivacyAccountant at realized q


def _check_slice(cfg: GFLConfig) -> None:
    unported = {
        "fault": (cfg.fault, "none", "ROADMAP slice 2: resilience"),
        "cohort": (cfg.cohort, "uniform", "ROADMAP slice 3: weighted path"),
        "population": (cfg.population, "dense",
                       "ROADMAP slice 3: lazy populations"),
        "async_spec": (cfg.async_spec, "none",
                       "ROADMAP slice 4: the event engine"),
        "telemetry": (cfg.telemetry, "off", "ROADMAP slice 5: telemetry"),
        "sanitize": (cfg.sanitize, False, "ROADMAP slice 5: sanitizer"),
    }
    for field, (value, ported, where) in unported.items():
        if value != ported:
            raise NotImplementedError(
                f"GFLConfig.{field}={value!r} is not ported yet ({where})")


def run_gfl_population(source, cfg: GFLConfig, *, iters: int,
                       batch_size: int = 10, seed: int = 0,
                       record_every: int = 1,
                       A: Optional[np.ndarray] = None,
                       scheduler: Optional[CohortScheduler] = None,
                       w_ref=None, scan: bool = False,
                       draws=None) -> PopulationRunResult:
    """Run the GFL protocol over a client population (pure path).

    Randomness: ``draws`` (a :class:`~repro_torch.draws.Draws` or a replay
    of the reference's draws), else ``Draws(seed)`` on the population's
    device.  The result carries a :class:`PrivacyAccountant` charged once
    per round at the realized sampling rate."""
    _check_slice(cfg)
    pop = as_population(source)
    P, K = pop.P, pop.num_clients
    device = pop.features.device
    grad_fn = make_grad_fn(pop.rho)
    if scheduler is None:
        scheduler = CohortScheduler.from_config(
            cfg, K=K, L=cfg.clients_sampled or K)
    L = scheduler.L
    if w_ref is None:
        w_ref = pop.w_ref
    w_ref_t = torch.as_tensor(w_ref, dtype=torch.float32, device=device)
    if A is None:
        A = base_combination_matrix(cfg, P)
    if draws is None:
        draws = Draws(seed, device)

    if scan:
        if cfg.combine_every > 1:
            raise ValueError("scan executor supports the combine_every=1 "
                             "pure path; use scan=False")
        msd, params = _run_pure_loop(pop, cfg, A, grad_fn, L, batch_size,
                                     iters, 1, w_ref_t, draws)
        msd = msd[::record_every]
    else:
        msd, params = _run_pure_loop(pop, cfg, A, grad_fn, L, batch_size,
                                     iters, record_every, w_ref_t, draws)
    q = np.full(iters, L / K)
    scheduler.q_history.extend(q.tolist())
    acc = mechanism_for(cfg).accountant()
    acc.sampling_rate = L / K
    for qi in q:
        acc.advance(1, q=float(qi))
    return PopulationRunResult(msd, params, q, scheduler, accountant=acc)


def _run_pure_loop(pop, cfg, A, grad_fn, L, batch_size, iters,
                   record_every, w_ref_t, draws):
    """The dense simulator's loop over the population gather.  MSD stays on
    the device until the run ends.  Returns (msd [T], params)."""
    step = gfl.make_gfl_step(A, grad_fn, cfg)
    state = gfl.init_state(pop.P, pop.dim, device=w_ref_t.device)
    msds = []
    for i in range(iters):
        state = step(state, uniform_cohort_batch(draws, i, pop, L,
                                                 batch_size), draws)
        if i % record_every == 0:
            msds.append(((gfl.centroid(state.params) - w_ref_t) ** 2).sum())
    msd = (torch.stack(msds).cpu().numpy() if msds
           else np.zeros(0, np.float32))
    return msd, state.params
