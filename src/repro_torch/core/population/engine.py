"""Streaming population-scale executor for the GFL protocol (port of
``repro.core.population.engine``).

Per round only the sampled ``[P, L]`` cohort is materialized
(``ClientPopulation.gather``), so memory and compute do not grow with the
population size K.  Two paths:

**Pure path** (``CohortScheduler.pure``: uniform sampler, always-available
trace): the dense simulator's loop.  Each round draws the cohort (L
clients per server without replacement, B samples each), gathers its
minibatches and takes one :func:`~repro_torch.core.gfl.make_gfl_step` step
— the resilience runtime's step when ``cfg.fault`` (or an explicit
``process``) sets a fault model.

**Weighted path** (importance sampling and/or an availability trace):
cohorts are drawn WITH replacement from the scheduler's effective
probabilities and each client's update carries the unbiased 1/(K pi)
weight of [23] (:mod:`repro_torch.core.sampling`), applied before the
sensitivity clip; the observed gradient norms feed the sampler's running
estimates.  Mid-round dropout goes through the fused fold's survivor
weights or the mechanism's dropout-safe ``client_protect_masked`` hook;
link faults realize A_i from the ``TopologyProcess`` each round.
Stragglers (which need the runtime's psi cache) and ``scan=True`` are
pure-path only and raise ``ValueError``, as in the reference.

The reference syncs the MSD (and a weighted round's q) to the host every
round; the port keeps the per-round MSD, q and straggler ages on the
device and copies each trace once per run.  On a card both paths run
through the round graph (:mod:`repro_torch.core.population.graphed`):
one round captured as a CUDA graph and replayed every round (the weighted
round as :class:`StagedWeightedStep`; ``scan=True``, in the reference one
``lax.scan`` over the whole run, is the same rounds of the pure path,
static topology and ``combine_every=1`` only).  ``executor="eager"`` runs
the same stage and body op by op instead, as the CPU always does.

``cfg.async_spec`` is ignored here, as in the reference: the event engine
(:func:`repro_torch.core.events.run_gfl_async`) reads it, and at its sync
limit runs this module's pure path.

Telemetry (``cfg.telemetry`` / ``REPRO_TELEMETRY``): the run's ``round``
records are built from its traces after the run; the ``step`` stream
(update and param norms on the loop, the MSD under ``scan=True``) and the
weighted path's gradient-norm columns come from device buffers the round
writes (:class:`~repro_torch.telemetry.MetricsStream`), drained after the
run; the accountant emits the ``privacy`` stream.  With no session the
rounds are the uninstrumented ones.  Sanitize mode (``cfg.sanitize`` /
``REPRO_SANITIZE``) runs inside :func:`repro_torch.sanitize.
sanitizer_scope`, checks the traces and params for non-finite values
after the run, and cross-checks the release ledger.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core import gfl
from repro_torch.core.population import graphed
from repro_torch.core.population.cohort import (
    CohortScheduler,
    CohortSelection,
)
from repro_torch.core.population.population import (
    ClientPopulation,
    DensePopulation,
    population_from_spec,
)
from repro_torch.core.privacy.mechanism import RoundContext, mechanism_for
from repro_torch.core.resilience.process import TopologyProcess
from repro_torch.core.resilience.runtime import ensure_dropout_safe
from repro_torch.core.simulate import (
    _solve_global,
    base_combination_matrix,
    make_grad_fn,
)
from repro_torch.draws import Draws
from repro_torch.sanitize import (
    ReleaseLedger,
    SanitizerError,
    check_finite,
    sanitize_enabled,
    sanitizer_scope,
)
from repro_torch.telemetry import (
    MetricsStream,
    RunLog,
    session_from_config,
    telemetry_active,
    trace_span,
)


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


def as_population(source, cfg: Optional[GFLConfig] = None,
                  device=None) -> ClientPopulation:
    """The engine's data source: a ClientPopulation passes through, a
    materialized LogisticProblem is wrapped dense, None builds the
    population named by ``cfg.population`` on ``device``."""
    if isinstance(source, ClientPopulation):
        return source
    if source is None:
        if cfg is None:
            raise ValueError("a population built from the config needs cfg")
        return population_from_spec(cfg, device=device)
    if hasattr(source, "features") and hasattr(source, "labels"):
        return DensePopulation.from_problem(source)
    raise TypeError(f"cannot interpret {type(source).__name__} as a "
                    "client population")


def estimate_w_ref(pop: ClientPopulation, *, sample_clients: int = 32,
                   seed: int = 0, iters: int = 2000) -> torch.Tensor:
    """Monte-Carlo reference minimizer for lazy populations: gather a
    uniform client subsample (``sample_clients`` a server, drawn without
    replacement by a numpy Generator seeded with ``seed``, in O(C) at any
    K) with every sample of each, and solve its strongly-convex empirical
    risk to machine precision (exact when sample_clients >= K)."""
    C = min(sample_clients, pop.num_clients)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(pop.num_clients, C, replace=False)
                    for _ in range(pop.P)])
    N = pop.samples_per_client
    client_idx = torch.from_numpy(idx).to(pop.device)
    bidx = torch.arange(N, device=pop.device).expand(pop.P, C, N)
    h, g = pop.gather(client_idx, bidx)
    return _solve_global(h, g, pop.rho, iters=iters)


class PopulationRunResult(NamedTuple):
    """Trajectory of one population-engine run.  ``gaps`` / ``staleness``
    are the resilience runtime's realizations when a fault process drives
    the run (None otherwise): ``spectral_gap(A_i)`` every round, and, on
    the pure path, the per-server straggler psi ages after every round."""
    msd: np.ndarray            # centroid MSD vs w_ref, every record_every
    params: torch.Tensor       # final [P, D] per-server models
    q: np.ndarray              # realized per-round sampling rate
    scheduler: CohortScheduler  # carries the IS state and q ledger
    gaps: Optional[np.ndarray] = None        # [iters] realized spectral gaps
    staleness: Optional[np.ndarray] = None   # [iters, P] straggler psi ages
    accountant: Optional[object] = None   # PrivacyAccountant at realized q


def run_gfl_population(source, cfg: GFLConfig, *, iters: int,
                       batch_size: int = 10, seed: int = 0,
                       record_every: int = 1,
                       A: Optional[np.ndarray] = None,
                       process: Optional[TopologyProcess] = None,
                       scheduler: Optional[CohortScheduler] = None,
                       w_ref=None, scan: bool = False,
                       draws=None, executor=None,
                       device=None) -> PopulationRunResult:
    """Run the GFL protocol over a (virtual) client population.

    ``source``: a :class:`ClientPopulation`, a materialized
    ``LogisticProblem`` (wrapped dense), or None (built from
    ``cfg.population`` on ``device``).  The cohort comes from
    ``cfg.cohort`` (or an explicit ``scheduler``), faults from ``process``,
    else from ``cfg.fault`` over the base matrix (``A`` or the config's)
    with ``cfg.topology_seed``, as in ``run_gfl``.  A lazy population's
    ``w_ref`` is estimated (:func:`estimate_w_ref`) unless given.
    Randomness: ``draws`` (a :class:`~repro_torch.draws.Draws` or a replay
    of the reference's draws, which needs the eager executor), else
    ``Draws(seed)`` on the population's device.  ``executor``:
    ``"graph"`` (the default on a card) or ``"eager"`` (the CPU's only
    one).  The result carries a :class:`PrivacyAccountant` charged once
    per round at that round's realized sampling rate; telemetry and
    sanitize mode as in the module docstring."""
    sanitize = sanitize_enabled(cfg)
    with session_from_config(cfg):
        with sanitizer_scope() if sanitize else nullcontext():
            with trace_span("population_run", iters=iters, scan=scan):
                res = _run_population_impl(
                    source, cfg, iters=iters, batch_size=batch_size,
                    seed=seed, record_every=record_every, A=A,
                    process=process, scheduler=scheduler, w_ref=w_ref,
                    scan=scan, draws=draws, executor=executor,
                    device=device)
        acc = mechanism_for(cfg).accountant()
        acc.sampling_rate = res.scheduler.L / res.scheduler.K
        with trace_span("privacy_accounting", releases=iters):
            for qi in res.q:
                acc.advance(1, q=float(qi))
    if sanitize:
        ledger = ReleaseLedger()
        ledger.record_release(iters)   # one client-level release per round
        ledger.charge_from(acc)
        ledger.cross_check()
        if not np.all(np.isfinite(res.msd)):
            raise SanitizerError("non-finite MSD trajectory under "
                                 "sanitize mode")
    return res._replace(accountant=acc)


def _run_population_impl(source, cfg: GFLConfig, *, iters: int,
                         batch_size: int, seed: int, record_every: int, A,
                         process, scheduler, w_ref, scan: bool, draws,
                         executor, device) -> PopulationRunResult:
    pop = as_population(source, cfg, device)
    P, K = pop.P, pop.num_clients
    dev = pop.device
    executor = graphed.resolve_executor(executor, dev)
    grad_fn = make_grad_fn(pop.rho)
    if scheduler is None:
        scheduler = CohortScheduler.from_config(
            cfg, K=K, L=cfg.clients_sampled or K)
    L = scheduler.L
    if w_ref is None:
        w_ref = pop.w_ref
    if w_ref is None:
        # a lazy population carries no minimizer: estimate one, so the
        # MSD is a mean-square deviation and not a distance to the origin
        w_ref = estimate_w_ref(pop)
    w_ref_t = torch.as_tensor(w_ref, dtype=torch.float32, device=dev)
    if process is None and cfg.fault != "none":
        base = A if A is not None else base_combination_matrix(cfg, P)
        process = TopologyProcess(base, cfg.fault, seed=cfg.topology_seed)
    if A is None:
        A = base_combination_matrix(cfg, P)
    if draws is None:
        draws = Draws(seed, dev)

    gaps = ages = norms = None
    if not scheduler.pure:
        msd, params, q, gaps, norms = _run_weighted(
            pop, cfg, scheduler, A, process, grad_fn, batch_size, iters,
            w_ref_t, draws, executor, scan)
    elif scan:
        if process is not None or cfg.combine_every > 1:
            raise ValueError("scan executor supports the static-topology, "
                             "combine_every=1 pure path; use scan=False")
        with trace_span("population_scan", iters=iters):
            msd, params, gaps, ages = _run_pure_loop(
                pop, cfg, A, None, grad_fn, L, batch_size, iters, 1,
                w_ref_t, draws, executor, tap="msd")
    else:
        msd, params, gaps, ages = _run_pure_loop(
            pop, cfg, A, process, grad_fn, L, batch_size, iters,
            record_every, w_ref_t, draws, executor)
    if scheduler.pure:
        q = np.full(iters, L / K)
    scheduler.q_history.extend(q.tolist())
    check_finite("MSD trajectory", msd)
    check_finite("params", params)
    # the loop path's trace holds every record_every-th round; the scan
    # and weighted paths' every round, cut to it here
    every_round = scan or not scheduler.pure
    if telemetry_active():
        if scan:
            row_msd = list(msd)
        elif every_round:
            row_msd = [m if i % record_every == 0 else None
                       for i, m in enumerate(msd)]
        else:
            row_msd = [msd[i // record_every] if i % record_every == 0
                       else None for i in range(iters)]
        _round_records(row_msd, q, L, gaps, ages, norms)
    if every_round:
        msd = msd[::record_every]
    return PopulationRunResult(msd, params, q, scheduler, gaps=gaps,
                               staleness=ages)


def _round_records(row_msd, q, L, gaps, ages, norms) -> None:
    """The run's ``round`` records (the reference's ``RunLog`` rows), from
    its traces: the MSD where the run recorded one, the realized q, the
    fault realizations and the gradient-norm columns the run kept."""
    log = RunLog("population")
    for i, m in enumerate(row_msd):
        log.row(i, msd=None if m is None else float(m),
                gap=None if gaps is None else float(gaps[i]),
                staleness=None if ages is None else ages[i],
                q=float(q[i]), cohort=L,
                **({} if norms is None else
                   {k: float(v[i]) for k, v in norms.items()}))


# ------------------------------------------------------- the weighted path


def _weighted_round(params: torch.Tensor, sel: CohortSelection, A, draws,
                    ctx: RoundContext, combine: bool, *, pop, cfg, mech,
                    grad_fn, use_alive: bool):
    """One weighted round (the reference's ``_make_weighted_round``):
    returns (new params [P, D], the sampler's feedback norms [P, L])."""
    h, g = pop.gather(sel.client_idx, sel.batch_idx)
    grads = gfl._client_grads(params, (h, g), grad_fn)
    alive = sel.alive if use_alive else None
    fold_w, noise_w = gfl._survivor_weights(alive)
    # fused: the importance weights before the clip (pre_w), the survivors
    # as fold weights with the noise/masks at their mean
    fused = gfl._fused_client_fold(params, grads, draws, cfg, mech, ctx,
                                   pre_w=sel.weights, fold_w=fold_w,
                                   noise_w=noise_w)
    if fused is not None:
        psi, sq = fused
        # the feedback is the unweighted clipped norm, from K1's sums
        norms = torch.sqrt(sq)
        if cfg.grad_bound > 0:
            norms = torch.clamp(norms, max=cfg.grad_bound)
    else:
        # the weight goes on BEFORE the sensitivity clip: each client's
        # step stays inside the mu*B ball the noise calibration assumes
        step_g = gfl.clip_to_bound(sel.weights[..., None] * grads,
                                   cfg.grad_bound)
        clipped = gfl.clip_to_bound(grads, cfg.grad_bound)
        w_clients = params[:, None, :] - cfg.mu * step_g
        norms = torch.linalg.vector_norm(clipped, dim=-1)
        psi = (mech.client_protect_masked(w_clients, draws, alive, ctx)
               if use_alive else mech.client_protect(w_clients, draws, ctx))
    new = mech.server_combine(psi, draws, A, ctx) if combine else psi
    return new, norms


class StagedWeightedStep(gfl.StagedStep):
    """The weighted round split for the round graph; the eager executor
    runs the same stage and body, op by op.

    :meth:`stage` (host) realizes the round's availability [P, K] (skipped
    under the ``always`` trace, whose mask never changes), the dropout
    mask [P, L] and, under link faults, A_i, and copies them into the
    step's buffers through pinned slots (:class:`graphed.PinnedCopies`);
    then the draws are reseeded.
    :meth:`body` (device) reads only those buffers, the params, the IS
    state and the counter: sampling probabilities, effective
    probabilities, the weighted draw, the weights, the gather, the
    gradients, K1/K2 (or the reference path), K3, the IS update in place,
    and the round's q at the counter into ``q``.  Observed, the body also
    writes the mean and max feedback norm into ``norm_tap``."""

    norm_tap = None     # MetricsStream of the round stream, when observed

    def __init__(self, pop: ClientPopulation, cfg: GFLConfig,
                 scheduler: CohortScheduler, process, A, grad_fn,
                 batch_size: int, iters: int, device):
        super().__init__(A, grad_fn, cfg, pop.P, pop.dim, iters, device)
        self.pop, self.scheduler, self.process = pop, scheduler, process
        self.batch_size = batch_size
        self.use_alive = scheduler.fault.client_dropout > 0
        self.topology = process is not None and not process.static
        self.A = self.A.clone()
        self.avail = torch.ones((pop.P, pop.num_clients), dtype=torch.bool,
                                device=device)
        self.alive = (torch.ones((pop.P, scheduler.L), dtype=torch.bool,
                                 device=device) if self.use_alive else None)
        self.q = torch.zeros(iters, dtype=torch.float64, device=device)
        self.copies = graphed.PinnedCopies()

    def stage(self, i: int, draws) -> bool:
        if not self.scheduler.trace.always_on:
            self.copies.copy(self.avail, self.scheduler.availability(i))
        if self.use_alive:
            self.copies.copy(self.alive, self.scheduler.client_alive(i))
        if self.topology:
            self.copies.copy(self.A, self.process.realize(i).A)
        return super().stage(i, draws)

    def body(self, batch, draws, i: int, combine: bool) -> None:
        ctx = self.context(i)
        sel = self.scheduler.weighted(
            draws, i, self.avail, self.alive,
            N=self.pop.samples_per_client, batch_size=self.batch_size)
        new, norms = _weighted_round(
            self.params, sel, self.A, draws, ctx, combine, pop=self.pop,
            cfg=self.cfg, mech=self.mech, grad_fn=self.grad_fn,
            use_alive=self.use_alive)
        self.params.copy_(new)
        self.scheduler.observe(sel.client_idx, norms)
        self.q.index_copy_(0, self.counter, sel.q.reshape(1))
        if self.norm_tap is not None:
            self.norm_tap.tap(self.counter, {"grad_norm_mean": norms.mean(),
                                             "grad_norm_max": norms.max()})


def _run_weighted(pop, cfg, scheduler, A, process, grad_fn, batch_size,
                  iters, w_ref_t, draws, executor, scan):
    """The weighted loop (importance sampling and/or an availability
    trace), with the reference's refusals: :class:`StagedWeightedStep`'s
    rounds, replayed from the round graph or, with ``executor="eager"``,
    staged and run op by op.  Returns (msd [iters], params, q [iters],
    gaps [iters] or None, the gradient-norm columns when observed)."""
    if scan:
        raise ValueError(
            "scan executor supports only the pure cohort path (uniform "
            "sampler, always trace); weighted cohorts need per-round host "
            "realizations — use scan=False")
    if process is not None and process.fault.straggler > 0:
        raise ValueError(
            "straggler faults need the resilience runtime's psi cache and "
            "are only supported on the pure cohort path (uniform sampler, "
            "always trace); drop the straggler: component or use "
            "cohort='uniform'")
    if scheduler.fault.client_dropout > 0:
        ensure_dropout_safe(mechanism_for(cfg).noise_profile(),
                            where="population cohort dropout")
    dev = w_ref_t.device
    scheduler.place(dev)
    step = StagedWeightedStep(pop, cfg, scheduler, process, A, grad_fn,
                              batch_size, iters, dev)
    if telemetry_active():
        step.norm_tap = MetricsStream(
            "round", ("grad_norm_mean", "grad_norm_max"), length=iters,
            device=dev)
    msd, params, _ = graphed.run_rounds(step, None, draws, iters, w_ref_t,
                                        capture=executor == "graph")
    q = step.q
    gaps = (None if process is None else
            np.asarray([process.realize(i).gap for i in range(iters)]))
    norms = None if step.norm_tap is None else step.norm_tap.columns()
    return msd.cpu().numpy(), params, q.cpu().numpy(), gaps, norms


# ----------------------------------------------------------- the pure path


def _run_pure_loop(pop, cfg, A, process, grad_fn, L, batch_size, iters,
                   record_every, w_ref_t, draws, executor="eager", *,
                   tap="norms"):
    """The dense simulator's loop over the population gather.  MSD and
    straggler ages stay on the device until the run ends.  Returns
    (msd [T], params, gaps [iters] or None, ages [iters, P] or None).

    Observed, the ``step`` stream is drained after the run: the update
    and param norms of every round (``tap="norms"``, the reference's
    jitted step; not on a faulted run, whose step the reference leaves
    untapped) or the MSD of every round (``tap="msd"``, its scan)."""
    observed = telemetry_active() and process is None
    taps = None
    if observed and tap == "norms":
        taps = MetricsStream("step", ("step", "update_norm", "param_norm"),
                             length=iters, device=w_ref_t.device)
    if executor == "graph":
        out = _run_pure_graph(pop, cfg, A, process, grad_fn, L, batch_size,
                              iters, record_every, w_ref_t, draws,
                              taps=taps)
    else:
        out = _run_pure_eager(pop, cfg, A, process, grad_fn, L, batch_size,
                              iters, record_every, w_ref_t, draws, taps)
    if observed and tap == "msd":      # the MSD trace, already on the host
        taps = MetricsStream("step", ("step", "msd"), length=iters,
                             device="cpu")
        taps.load("msd", torch.from_numpy(out[0]))
    if taps is not None:
        taps.drain()
    return out


def _run_pure_eager(pop, cfg, A, process, grad_fn, L, batch_size, iters,
                    record_every, w_ref_t, draws, taps):
    with trace_span("population_compile", faulted=process is not None):
        step = gfl.make_gfl_step(process if process is not None else A,
                                 grad_fn, cfg)
    state = gfl.init_state(pop.P, pop.dim, device=w_ref_t.device)
    msds, gaps, ages = [], [], []
    for i in range(iters):
        prev = state.params
        state = step(state, uniform_cohort_batch(draws, i, pop, L,
                                                 batch_size), draws)
        if taps is not None:
            gfl.tap_step_norms(taps, i, state.params, prev)
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
                    record_every, w_ref_t, draws, capture=True, *, taps=None):
    """``_run_pure_loop`` through the round graph (``capture=False``: its
    staged rounds run eagerly, as the CPU tests run them).  The body
    records every round's MSD; the trace keeps every ``record_every``-th.
    ``taps``: the ``step`` stream the unfaulted body writes."""
    dev = w_ref_t.device
    if process is None:
        step = gfl.StagedStep(A, grad_fn, cfg, pop.P, pop.dim, iters, dev)
        step.norms_tap = taps
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
