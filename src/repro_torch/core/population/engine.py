"""Population executor, pure path (port of
``repro.core.population.engine``).

The pure path is the dense simulator's loop: each round draws the cohort
(L clients per server without replacement, B samples each), gathers its
minibatches and takes one :func:`~repro_torch.core.gfl.make_gfl_step`
step — the resilience runtime's step when ``cfg.fault`` (or an explicit
``process``) sets a fault model.  The reference syncs the MSD to the host
every round; the port keeps the per-round MSD and straggler ages on the
device and copies each trace once per run.

On a card both the loop and ``scan=True`` (in the reference one
``lax.scan`` over the whole run; here the same rounds, recording every
one, for the static, ``combine_every=1`` path only) run through the round
graph (:mod:`repro_torch.core.population.graphed`): one round captured
as a CUDA graph and replayed every round.  ``executor="eager"`` runs the
rounds op by op instead (:func:`~repro_torch.core.gfl.make_gfl_step`), as
the CPU always does.

Not in this slice (they raise ``NotImplementedError`` naming their
ROADMAP slice): the weighted path (importance sampling, availability
traces, and faults there), lazy populations, telemetry and the sanitizer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core import gfl
from repro_torch.core.population import graphed
from repro_torch.core.population.cohort import CohortScheduler
from repro_torch.core.population.population import (
    ClientPopulation,
    DensePopulation,
)
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.resilience.process import TopologyProcess
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
    """Trajectory of one population-engine run.  ``gaps`` / ``staleness``
    are the resilience runtime's realizations when a fault process drives
    the run (None otherwise): ``spectral_gap(A_i)`` every round, and the
    per-server straggler psi ages after every round."""
    msd: np.ndarray            # centroid MSD vs w_ref, every record_every
    params: torch.Tensor       # final [P, D] per-server models
    q: np.ndarray              # realized per-round sampling rate
    scheduler: CohortScheduler
    gaps: Optional[np.ndarray] = None        # [iters] realized spectral gaps
    staleness: Optional[np.ndarray] = None   # [iters, P] straggler psi ages
    accountant: Optional[object] = None   # PrivacyAccountant at realized q


def _check_slice(cfg: GFLConfig, faulted: bool) -> None:
    if faulted and cfg.cohort != "uniform":
        raise NotImplementedError(
            f"a fault process (GFLConfig.fault={cfg.fault!r}) on the weighted "
            f"path (cohort={cfg.cohort!r}) is not ported yet (ROADMAP slice "
            "3: weighted path)")
    unported = {
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
                       process: Optional[TopologyProcess] = None,
                       scheduler: Optional[CohortScheduler] = None,
                       w_ref=None, scan: bool = False,
                       draws=None, executor=None) -> PopulationRunResult:
    """Run the GFL protocol over a client population (pure path).

    Faults come from ``process``, else from ``cfg.fault`` over the base
    matrix (``A`` or the config's) with ``cfg.topology_seed``, as in
    ``run_gfl``.  Randomness: ``draws`` (a
    :class:`~repro_torch.draws.Draws` or a replay of the reference's
    draws, which needs the eager executor), else ``Draws(seed)`` on the
    population's device.  ``executor``: ``"graph"`` (the default on a
    card) or ``"eager"`` (the CPU's only one).  The result carries a
    :class:`PrivacyAccountant` charged once per round at the realized
    sampling rate."""
    _check_slice(cfg, process is not None or cfg.fault != "none")
    pop = as_population(source)
    P, K = pop.P, pop.num_clients
    device = pop.features.device
    executor = graphed.resolve_executor(executor, device)
    grad_fn = make_grad_fn(pop.rho)
    if scheduler is None:
        scheduler = CohortScheduler.from_config(
            cfg, K=K, L=cfg.clients_sampled or K)
    L = scheduler.L
    if w_ref is None:
        w_ref = pop.w_ref
    w_ref_t = torch.as_tensor(w_ref, dtype=torch.float32, device=device)
    if process is None and cfg.fault != "none":
        base = A if A is not None else base_combination_matrix(cfg, P)
        process = TopologyProcess(base, cfg.fault, seed=cfg.topology_seed)
    if A is None:
        A = base_combination_matrix(cfg, P)
    if draws is None:
        draws = Draws(seed, device)

    if scan:
        if process is not None or cfg.combine_every > 1:
            raise ValueError("scan executor supports the static-topology, "
                             "combine_every=1 pure path; use scan=False")
        msd, params, gaps, ages = _run_pure_loop(
            pop, cfg, A, None, grad_fn, L, batch_size, iters, 1, w_ref_t,
            draws, executor)
        msd = msd[::record_every]
    else:
        msd, params, gaps, ages = _run_pure_loop(
            pop, cfg, A, process, grad_fn, L, batch_size, iters,
            record_every, w_ref_t, draws, executor)
    q = np.full(iters, L / K)
    scheduler.q_history.extend(q.tolist())
    acc = mechanism_for(cfg).accountant()
    acc.sampling_rate = L / K
    for qi in q:
        acc.advance(1, q=float(qi))
    return PopulationRunResult(msd, params, q, scheduler, gaps=gaps,
                               staleness=ages, accountant=acc)


def _run_pure_loop(pop, cfg, A, process, grad_fn, L, batch_size, iters,
                   record_every, w_ref_t, draws, executor="eager"):
    """The dense simulator's loop over the population gather.  MSD and
    straggler ages stay on the device until the run ends.  Returns
    (msd [T], params, gaps [iters] or None, ages [iters, P] or None)."""
    if executor == "graph":
        return _run_pure_graph(pop, cfg, A, process, grad_fn, L, batch_size,
                               iters, record_every, w_ref_t, draws)
    step = gfl.make_gfl_step(process if process is not None else A,
                             grad_fn, cfg)
    state = gfl.init_state(pop.P, pop.dim, device=w_ref_t.device)
    msds, gaps, ages = [], [], []
    for i in range(iters):
        state = step(state, uniform_cohort_batch(draws, i, pop, L,
                                                 batch_size), draws)
        if process is not None:
            gaps.append(process.realize(i).gap)   # the step's memoized one
            ages.append(state.psi_age)
        if i % record_every == 0:
            msds.append(((gfl.centroid(state.params) - w_ref_t) ** 2).sum())
    msd = (torch.stack(msds).cpu().numpy() if msds
           else np.zeros(0, np.float32))
    if process is None or not iters:
        return msd, state.params, None, None
    return (msd, state.params, np.asarray(gaps),
            torch.stack(ages).cpu().numpy())


def _run_pure_graph(pop, cfg, A, process, grad_fn, L, batch_size, iters,
                    record_every, w_ref_t, draws, capture=True):
    """``_run_pure_loop`` through the round graph (``capture=False``: its
    staged rounds run eagerly, as the CPU tests run them).  The body
    records every round's MSD; the trace keeps every ``record_every``-th."""
    dev = w_ref_t.device
    if process is None:
        step = gfl.StagedStep(A, grad_fn, cfg, pop.P, pop.dim, iters, dev)
    else:
        from repro_torch.core.resilience.runtime import StagedResilientStep
        step = StagedResilientStep(process, grad_fn, cfg, pop.P, pop.dim, L,
                                   iters, dev)
    msd, params, ages = graphed.run_rounds(
        step, lambda i: uniform_cohort_batch(draws, i, pop, L, batch_size),
        draws, iters, w_ref_t, capture=capture)
    msd = msd[::record_every].cpu().numpy()
    if process is None or not iters:
        return msd, params, None, None
    gaps = np.asarray([process.realize(i).gap for i in range(iters)])
    return msd, params, gaps, ages.cpu().numpy()
