"""Event-driven async GFL executor: buffered, staleness-weighted ticks (port
of ``repro.core.events.engine``).

The synchronous executors (``run_gfl`` / ``run_gfl_population``) assume a
round barrier.  This module drops it (FedBuff-style semi-async): clients
arrive on their own clocks (:mod:`repro_torch.core.events.queue`, the
availability traces reused as arrival intensities), each arrival carries
an AGE (which past model snapshot it was computed against, drawn from the
``AsyncSpec.latency`` distribution and bounded by ``max_stale``), and each
server aggregates when **its own buffer fills**
(:mod:`repro_torch.core.events.buffer`).

One tick (:class:`StagedEventTick`, run by the round graph's
:func:`~repro_torch.core.population.graphed.run_rounds`: captured once as
a CUDA graph and replayed every tick on a card, staged and run op by op
with ``executor="eager"``, as the CPU always does):

  *stage* (host): the run's draws reseeded for the tick; on the loop path
  the tick's arrival uniforms and ages [P, E] and, under link faults, A_t
  realized in numpy and copied into static buffers (pageable copies, as
  ``runtime.stage_round`` makes them).  With ``scan=True`` the whole
  horizon is realized and copied once, and the body reads it at the tick
  counter; the per-tick stage is then only the reseed.

  *body* (device): draw the cohort (uniform without replacement, or
  importance with replacement and the 1/(K pi) weights); gather the lazy
  population; thin arrivals by trace intensity and refuse ages beyond the
  staleness bound; per-event gradients against the stale snapshots; the
  staleness-weighted protected fold (K1 + K2 with ``pre_w`` the importance
  weights, ``fold_w`` the staleness weights, ``noise_w`` = valid/n_valid,
  per-event bases when ``max_stale > 0``; the mechanism's hooks with the
  kernels off); the buffer fold and per-server flush; the gated graph
  combine (K3's gate/cache variant with the kernels on); the snapshot
  ring; the tick's MSD, flush mask, q, mean age, events and drops written
  at the device tick counter.

A graph cannot branch on a device value, so where the reference runs the
combine under ``lax.cond(do_flush.any(), ...)`` the tick combines every
tick and keeps ``torch.where(do_flush.any(), combined, params)``.  The
combine noise comes from the tick's own ``combine`` stream, so drawing it
on a tick without a flush moves no other draw: the result is the cond's.

**Sync-limit contract**: with ``buffer == rate``, zero latency,
``max_stale = 0`` and a pure cohort (uniform sampler, always-on trace)
every tick is a lockstep synchronous round, and ``scan=False`` routes
through the population engine's pure path (``_run_pure_loop`` /
``_run_pure_graph``, the same draws and executor): bitwise
``run_gfl_population`` by construction.  ``scan=True`` there takes the
tick path, as in the reference.

Privacy: each *flush* is one ledger release of that server; the result
carries an :class:`~repro_torch.core.privacy.accountant.AsyncAccountant`
charged off its realized ``(flushed, q)`` schedule.

Telemetry: the ``round`` records are built from the tick's [T, P] traces
after the run, and under ``scan=True`` so is the ``step`` stream (MSD,
flushes, events, their running total, drops, mean age a tick), from the
same device traces: the tick body gains no op.  Sanitize mode checks the
traces and params for non-finite values after the run and cross-checks
``flushed.sum()`` releases against the accountant's ledgers.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import replace as dc_replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import GFLConfig
from repro_torch.core import gfl
from repro_torch.core import sampling as IS
from repro_torch.core.events.buffer import (
    BufferedServerState,
    assign,
    flush,
    fold_tick,
    init_buffers,
    staleness_weights,
)
from repro_torch.core.events.queue import EventQueue, trace_intensity_fn
from repro_torch.core.events.spec import AsyncSpec, parse_async_spec
from repro_torch.core.population import graphed
from repro_torch.core.population.cohort import (
    AvailabilityTrace,
    parse_cohort_spec,
    parse_trace_spec,
)
from repro_torch.core.population.engine import (
    _run_pure_loop,
    as_population,
    estimate_w_ref,
)
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.resilience.faults import parse_fault_spec
from repro_torch.core.resilience.process import TopologyProcess
from repro_torch.core.resilience.runtime import ensure_dropout_safe
from repro_torch.core.simulate import base_combination_matrix, make_grad_fn
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


class AsyncState(NamedTuple):
    """The tick's state, held in place across replays of the tick graph."""
    params: torch.Tensor             # [P, D] per-server models
    step: torch.Tensor               # [1] int64 device tick counter
    buffers: BufferedServerState
    hist: torch.Tensor               # [S+1, P, D] snapshot ring: tick t's
                                     # model at slot t mod (S+1); empty
                                     # [0, P, D] when max_stale == 0


class AsyncRunResult(NamedTuple):
    """Trajectory and release schedule of one async run."""
    msd: np.ndarray            # [T] centroid MSD vs w_ref per tick
    params: torch.Tensor       # final [P, D]
    flushed: np.ndarray        # [T, P] bool: which servers released when
    q: np.ndarray              # [T, P] realized per-flush sampling rate
    staleness: np.ndarray      # [T, P] mean folded age per tick
    events: np.ndarray         # [T, P] valid arrivals folded per tick
    dropped_stale: np.ndarray  # [T, P] arrivals refused at the bound
    gaps: Optional[np.ndarray]  # [T] realized spectral gaps (fault runs)
    spec: AsyncSpec
    accountant: Optional[object] = None  # AsyncAccountant, charged off the
                                         # realized flush/q schedule

    @property
    def releases(self) -> np.ndarray:
        """[P] total releases (flushes) per server."""
        return self.flushed.sum(axis=0)


def _importance_probs(P: int, K: int, floor: float, scheduler, device
                      ) -> torch.Tensor:
    """[P, K] with-replacement event-identity probabilities for the
    importance sampler: the scheduler's current norm-estimate state when
    one is passed (frozen for the run, as in the reference), else the
    fresh-state uniform mix."""
    state = (scheduler.is_state if scheduler is not None
             else IS.init_is_state(P, K))
    state = IS.ISState(*(t.to(device) for t in state))
    return IS.sampling_probs(state, floor=floor)


class StagedEventTick(gfl.StagedStep):
    """One event tick split for the round graph (module docstring).

    The body reads only buffers made here once a run — params, the tick
    counter, the aggregation buffers, the snapshot ring, the staged
    arrivals (or the horizon's) and A — and writes the [T] / [T, P]
    outputs at the counter.  ``max_pi`` (the importance sampler's q bound)
    is a Python float fixed for the run."""

    def __init__(self, pop, cfg: GFLConfig, spec: AsyncSpec,
                 trace: AvailabilityTrace, probs: Optional[torch.Tensor],
                 process: Optional[TopologyProcess], A, grad_fn,
                 batch_size: int, ticks: int, device, *, seed: int,
                 horizon: bool = False):
        super().__init__(A, grad_fn, cfg, pop.P, pop.dim, ticks, device)
        P, E, S = pop.P, spec.events_per_tick, spec.max_stale
        self.pop, self.spec, self.process = pop, spec, process
        self.E, self.S = E, S
        self.batch_size = batch_size
        self.queue = EventQueue(P, spec, seed=seed)
        self.use_trace = not trace.always_on
        self.use_latency = not spec.latency.is_zero
        self.use_mask = self.use_trace or self.use_latency
        self.probs = probs
        self.max_pi = None if probs is None else float(probs.max())
        self.inv_K = float(np.float32(1.0) / np.float32(pop.num_clients))
        self.intensity = (trace_intensity_fn(trace, pop.num_clients, device)
                          if self.use_trace else None)
        self.topology = process is not None and not process.static
        self.horizon = horizon
        self.buffers = init_buffers(self.params)
        self.hist = (self.params[None].repeat(S + 1, 1, 1) if S > 0 else
                     torch.zeros((0, P, pop.dim), device=device))
        self.servers = torch.arange(P, device=device)[:, None]
        if horizon:
            us, ages = self.queue.realize_horizon(ticks)
            self.u = torch.from_numpy(us).to(device)
            self.ages = torch.from_numpy(ages).to(device)
            if self.topology:
                self.A = torch.from_numpy(np.stack(
                    [process.realize(t).A for t in range(ticks)]
                ).astype(np.float32)).to(device)
        else:
            self.u = torch.zeros((P, E), dtype=torch.float32, device=device)
            self.ages = torch.zeros((P, E), dtype=torch.int32, device=device)
            self.A = self.A.clone()
        self.flushed = torch.zeros((ticks, P), dtype=torch.bool,
                                   device=device)
        self.q = torch.zeros((ticks, P), dtype=torch.float32, device=device)
        self.staleness = torch.zeros((ticks, P), dtype=torch.float32,
                                     device=device)
        self.events = torch.zeros((ticks, P), dtype=torch.int32,
                                  device=device)
        self.dropped = torch.zeros((ticks, P), dtype=torch.int32,
                                   device=device)

    @property
    def state(self) -> AsyncState:
        return AsyncState(self.params, self.counter, self.buffers, self.hist)

    def stage(self, i: int, draws) -> bool:
        # the reseed first: a pageable copy waits for the replay before it,
        # and the host's work before the copies overlaps that replay
        combine = super().stage(i, draws)
        if not self.horizon:
            u, ages = self.queue.realize(i)
            if self.use_trace:
                self.u.copy_(torch.from_numpy(u))
            if self.use_latency:
                self.ages.copy_(torch.from_numpy(ages))
            if self.topology:
                self.A.copy_(torch.from_numpy(
                    self.process.realize(i).A.astype(np.float32)))
        return combine

    def _inputs(self):
        """(arrival uniforms [P, E], ages [P, E], A_t [P, P]) of the tick."""
        if not self.horizon:
            return self.u, self.ages, self.A
        at = self.counter
        A_t = self.A.index_select(0, at)[0] if self.topology else self.A
        return (self.u.index_select(0, at)[0],
                self.ages.index_select(0, at)[0], A_t)

    def body(self, batch, draws, i: int, combine: bool) -> None:
        cfg, mech, spec = self.cfg, self.mech, self.spec
        pop, P, E, S = self.pop, self.pop.P, self.E, self.S
        K, N = pop.num_clients, pop.samples_per_client
        dev = self.params.device
        ctx = self.context(i)
        # -- cohort draw: uniform without replacement, or with-replacement
        #    importance draws (the weighted population path's sampler)
        if self.probs is not None:
            idx, bidx = draws.weighted_cohort(i, self.probs, N, E,
                                              self.batch_size)
        else:
            idx, bidx = draws.cohort(i, P, K, N, E, self.batch_size)
        h, g = pop.gather(idx, bidx)
        u, ages, A_t = self._inputs()

        # -- arrivals: intensity thinning + bounded staleness
        valid = torch.ones((P, E), dtype=torch.bool, device=dev)
        if self.intensity is not None:
            valid = valid & (u < self.intensity(self.counter, idx))
        if self.use_latency:
            ok_age = ages <= S
            dropped = (valid & ~ok_age).sum(dim=1)
            valid = valid & ok_age
            a = torch.clamp(ages, max=S)
        else:
            dropped = torch.zeros((P,), dtype=torch.int64, device=dev)
            a = torch.zeros((P, E), dtype=torch.int32, device=dev)
        s = staleness_weights(a, spec.alpha) * valid          # [P, E]
        n_valid = valid.sum(dim=1)                            # [P]
        wsum = s.sum(dim=1)                                   # [P]

        # -- the stale snapshots the arrivals were computed against: the
        #    ring slot of tick (t - age); at S == 0 the live [P, D] params
        if S > 0:
            w_base = self.hist[(self.counter - a) % (S + 1), self.servers]
        else:
            w_base = self.params
        grads = self.grad_fn(w_base, (h, g))                  # [P, E, D]
        rho = (None if self.probs is None
               else IS.importance_weights(self.probs, idx))
        fold_w = noise_w = None
        if self.use_mask:
            fold_w = s
            noise_w = (valid.to(torch.float32)
                       / torch.clamp(n_valid, min=1)[:, None])
        # kernels on: K1 + K2 over the tick's event batch — importance
        # weights before the clip, staleness weights as fold weights
        # (weight-normalized), the noise/masks at the survivor mean
        fused = gfl._fused_client_fold(w_base, grads, draws, cfg, mech, ctx,
                                       pre_w=rho, fold_w=fold_w,
                                       noise_w=noise_w)
        if fused is not None:
            contrib = fused[0]
        else:
            # importance weight BEFORE the sensitivity clip
            step_g = gfl.clip_to_bound(
                grads if rho is None else rho[..., None] * grads,
                cfg.grad_bound)
            wb = w_base if S > 0 else w_base[:, None, :]
            w_upd = wb - cfg.mu * step_g
            if self.use_latency:
                # pre-scaling by s n_valid / sum(s) makes the protected
                # survivor MEAN the weight-normalized fold sum(s x)/sum(s)
                scale = s * (n_valid.to(torch.float32)
                             / torch.clamp(wsum, min=1e-12))[:, None]
                w_upd = w_upd * scale[..., None]
            contrib = (mech.client_protect_masked(w_upd, draws, valid, ctx)
                       if self.use_mask
                       else mech.client_protect(w_upd, draws, ctx))

        # -- buffer fold, per-server flush, the gated combine
        buf = fold_tick(self.buffers, contrib, wsum, n_valid)
        n_at_flush = buf.buf_n
        if cfg.use_kernels:
            # K3 selects fold or cached psi per server from the gate
            cache = self.buffers.psi_cache
            do_flush, psi_fold, buf = flush(buf, spec.buffer, select=False)
            combined = mech.server_combine(psi_fold, draws, A_t, ctx,
                                           cache=cache,
                                           gate=do_flush.to(torch.float32))
        else:
            do_flush, psi, buf = flush(buf, spec.buffer)
            combined = mech.server_combine(psi, draws, A_t, ctx)
        # float32, as the reference's; its compiled n / K is n times the
        # float32 reciprocal of K
        rate = self.max_pi if self.max_pi is not None else self.inv_K
        q_flush = torch.clamp(n_at_flush * rate, max=1.0)
        q_flush = torch.where(do_flush, q_flush, 0.0)
        # a graph cannot branch on do_flush.any(): combine every tick and
        # keep the old params when no server flushed
        new_params = torch.where(do_flush.any(), combined, self.params)

        mean_age = ((a * valid).sum(dim=1)
                    / torch.clamp(n_valid, min=1)).to(torch.float32)
        at = self.counter
        self.flushed.index_copy_(0, at, do_flush[None])
        self.q.index_copy_(0, at, q_flush.to(torch.float32)[None])
        self.staleness.index_copy_(0, at, mean_age[None])
        self.events.index_copy_(0, at, n_valid.to(torch.int32)[None])
        self.dropped.index_copy_(0, at, dropped.to(torch.int32)[None])
        self.params.copy_(new_params)
        assign(self.buffers, buf)
        if S > 0:
            self.hist.index_copy_(0, (at + 1) % (S + 1), new_params[None])


def run_gfl_async(source, cfg: GFLConfig, *, ticks: int,
                  batch_size: int = 10, seed: int = 0,
                  A: Optional[np.ndarray] = None,
                  process: Optional[TopologyProcess] = None,
                  spec: Optional[AsyncSpec] = None,
                  scheduler=None, w_ref=None, scan: bool = False,
                  draws=None, executor=None, device=None) -> AsyncRunResult:
    """Run the event-driven executor for ``ticks`` event batches; the
    result carries an :class:`AsyncAccountant` charged off the realized
    flush/q schedule.

    ``source``/``cfg`` follow :func:`~repro_torch.core.population.engine.
    run_gfl_population` (``device`` builds a population from
    ``cfg.population``); the async behavior comes from ``cfg.async_spec``
    (or an explicit ``spec``), arrival intensities from the trace part of
    ``cfg.cohort``, link/outage faults from ``cfg.fault`` (per-tick A_t).
    Straggler and dropout fault components are refused, as in the
    reference: buffered aggregation with bounded staleness IS the async
    model of those regimes.  ``draws`` / ``executor`` as in
    ``run_gfl_population``; ``scan=True`` realizes the whole horizon once
    and runs the same tick graph (bitwise the loop).  Telemetry and
    sanitize mode as in the module docstring."""
    sanitize = sanitize_enabled(cfg)
    with session_from_config(cfg):
        with sanitizer_scope() if sanitize else nullcontext():
            with trace_span("async_run", ticks=ticks, scan=scan):
                res = _run_async_impl(
                    source, cfg, ticks=ticks, batch_size=batch_size,
                    seed=seed, A=A, process=process, spec=spec,
                    scheduler=scheduler, w_ref=w_ref, scan=scan,
                    draws=draws, executor=executor, device=device)
        acc = mechanism_for(cfg).async_accountant(res.flushed.shape[1])
        with trace_span("privacy_accounting", ticks=ticks):
            acc.record_schedule(res.flushed, res.q)
    if sanitize:
        ledger = ReleaseLedger()
        ledger.record_release(int(res.flushed.sum()))
        ledger.charge_from(acc)
        ledger.cross_check()
        if not np.all(np.isfinite(res.msd)):
            raise SanitizerError("non-finite MSD trajectory under "
                                 "sanitize mode")
    return res._replace(accountant=acc)


def _run_async_impl(source, cfg: GFLConfig, *, ticks: int, batch_size: int,
                    seed: int, A, process, spec, scheduler, w_ref,
                    scan: bool, draws, executor, device) -> AsyncRunResult:
    if spec is None:
        spec = parse_async_spec(cfg.async_spec)
    if spec is None:
        raise ValueError(
            "run_gfl_async needs an async spec: set GFLConfig.async_spec "
            "(e.g. 'async:buffer=8,latency=lognorm:0.5,max_stale=4') or "
            "pass spec=")
    if cfg.combine_every != 1:
        raise ValueError("the event executor combines on flush ticks; "
                         "combine_every amortization is a synchronous "
                         "knob — use combine_every=1")
    fault = parse_fault_spec(cfg.fault)
    if fault.straggler > 0 or fault.client_dropout > 0:
        raise ValueError(
            "async executor models stragglers/dropout through buffered "
            "aggregation with bounded staleness (latency=/max_stale=); "
            "drop the straggler:/dropout: fault components (links:/outage: "
            "compose fine)")
    sampler, floor, trace = parse_cohort_spec(cfg.cohort)

    pop = as_population(source, cfg, device)
    P, K = pop.P, pop.num_clients
    dev = pop.device
    E = spec.events_per_tick
    if not 1 <= E <= K:
        raise ValueError(f"events per tick E={E} not in [1, K={K}] "
                         "(the per-tick candidate draw is without "
                         "replacement)")
    executor = graphed.resolve_executor(executor, dev)
    grad_fn = make_grad_fn(pop.rho)
    if w_ref is None:
        w_ref = pop.w_ref
    if w_ref is None:
        w_ref = estimate_w_ref(pop)
    w_ref_t = torch.as_tensor(w_ref, dtype=torch.float32, device=dev)
    if process is None and cfg.fault != "none":
        base = A if A is not None else base_combination_matrix(cfg, P)
        process = TopologyProcess(base, cfg.fault, seed=cfg.topology_seed)
    if A is None:
        A = base_combination_matrix(cfg, P)
    if draws is None:
        draws = Draws(seed, dev)

    mech = mechanism_for(cfg)
    use_trace = not trace.always_on
    use_is = sampler == "importance"
    if use_trace or not spec.latency.is_zero:
        ensure_dropout_safe(mech.noise_profile(),
                            where="async event arrivals")

    if spec.is_sync_limit and not use_trace and not use_is and not scan:
        res = _run_lockstep_loop(pop, cfg, A, process, grad_fn, spec,
                                 batch_size, ticks, w_ref_t, draws,
                                 executor)
        check_finite("MSD trajectory", res.msd)
        check_finite("params", res.params)
        if telemetry_active():
            _round_records(res, lockstep=True)
        return res

    probs = (_importance_probs(P, K, floor, scheduler, dev) if use_is
             else None)
    step = StagedEventTick(pop, cfg, spec, trace, probs, process, A,
                           grad_fn, batch_size, ticks, dev,
                           seed=cfg.topology_seed, horizon=scan)
    with trace_span("async_scan", ticks=ticks) if scan else nullcontext():
        msd, params, _ = graphed.run_rounds(step, None, draws, ticks,
                                            w_ref_t,
                                            capture=executor == "graph")
    if scan and telemetry_active():
        _step_records(step, msd)
    gaps = (None if process is None else
            np.asarray([process.realize(t).gap for t in range(ticks)]))
    res = AsyncRunResult(
        msd.cpu().numpy(), params, step.flushed.cpu().numpy(),
        step.q.cpu().numpy(), step.staleness.cpu().numpy(),
        step.events.cpu().numpy(), step.dropped.cpu().numpy(), gaps, spec)
    for what, trace_ in (("MSD trajectory", res.msd), ("q", res.q),
                         ("staleness", res.staleness), ("params", params)):
        check_finite(what, trace_)
    if telemetry_active():
        _round_records(res)
    return res


def _step_records(step: StagedEventTick, msd: torch.Tensor) -> None:
    """The scan path's ``step`` stream (the reference's in-scan
    ``MetricsStream``), from the tick's device traces after the run: per
    tick the MSD, servers flushed, events folded and their running total,
    arrivals refused and the mean folded age."""
    ms = MetricsStream("step", ("step", "msd", "flushed", "events",
                                "events_total", "dropped", "staleness"),
                       length=msd.shape[0], device=msd.device,
                       cumulative={"events_total": "events"})
    ms.load("msd", msd)
    ms.load("flushed", step.flushed.sum(dim=1))
    ms.load("events", step.events.sum(dim=1))
    ms.load("dropped", step.dropped.sum(dim=1))
    ms.load("staleness", step.staleness.mean(dim=1))
    ms.drain()


def _round_records(res: AsyncRunResult, lockstep: bool = False) -> None:
    """The run's ``round`` records (the reference's ``RunLog("async")``
    rows), from its [T] / [T, P] traces."""
    log = RunLog("async")
    P = res.flushed.shape[1]
    for t in range(res.msd.shape[0]):
        gap = None if res.gaps is None else float(res.gaps[t])
        if lockstep:
            log.row(t, msd=float(res.msd[t]), gap=gap,
                    flushed=res.flushed[t].astype(np.int32),
                    q_server=res.q[t], events=res.events[t],
                    cohort=int(res.events[t][0]) if P else 0)
        else:
            log.row(t, msd=float(res.msd[t]),
                    flushed=res.flushed[t].astype(np.int32),
                    q_server=res.q[t], staleness=res.staleness[t],
                    events=res.events[t],
                    dropped_stale=res.dropped_stale[t], gap=gap)


def _run_lockstep_loop(pop, cfg, A, process, grad_fn, spec, batch_size,
                       ticks, w_ref_t, draws, executor) -> AsyncRunResult:
    """The sync limit: every tick is a lockstep round — the population
    engine's pure path with L = ``spec.buffer``, the same draws and the
    same executor, so trajectories are bitwise ``run_gfl_population``'s by
    construction."""
    P, K, E = pop.P, pop.num_clients, spec.buffer
    msd, params, gaps, _ = _run_pure_loop(
        pop, cfg, A, process, grad_fn, E, batch_size, ticks, 1, w_ref_t,
        draws, executor)
    T = ticks
    return AsyncRunResult(
        msd=msd, params=params, flushed=np.ones((T, P), bool),
        q=np.full((T, P), min(1.0, E / K)),
        staleness=np.zeros((T, P), np.float32),
        events=np.full((T, P), E, np.int32),
        dropped_stale=np.zeros((T, P), np.int32), gaps=gaps, spec=spec)


# ---------------------------------------------------------------------------
# mesh wiring: the event layer as a cohort-weight driver
# ---------------------------------------------------------------------------


class AsyncCohortDriver:
    """Host-side event layer for a mesh trainer: one training step = one
    tick, the step's sampled [P, L] cohort are the tick's candidate
    arrivals.

    Produces the per-step ``cohort_weights`` — validity-thinned,
    staleness-weighted and normalized so the server mean equals the
    weighted fold — plus the per-server (flushed, q) release schedule the
    :class:`~repro_torch.core.privacy.accountant.AsyncAccountant`
    consumes.  A server's weight row is ZERO until its buffer fills: its
    clients' data enters the published model only on its flush steps,
    exactly when its ledger is charged.  The availability trace must be
    applied exactly once: pass a trace here ONLY when no
    ``CohortScheduler`` already thinned the cohort at sampling time.
    The weights are a float32 tensor on ``device`` (``cuda`` unless told
    otherwise)."""

    def __init__(self, spec: AsyncSpec, P: int, L: int, K: int, *,
                 trace: "AvailabilityTrace | str" = "always", seed: int = 0,
                 device=None):
        self.spec = spec
        self.P, self.L, self.K = P, L, K
        self.trace = (parse_trace_spec(trace) if isinstance(trace, str)
                      else trace)
        self.device = resolve_device(device)
        # the mesh cohort is the event batch: L slots per server per tick
        self.queue = EventQueue(P, dc_replace(spec, rate=L), seed=seed)
        self.buf_n = np.zeros(P, np.int64)

    def step(self, t: int, client_ids: Optional[np.ndarray] = None):
        """(cohort_weights [P, L] float32 tensor, flushed [P] bool, q [P])
        of tick t."""
        spec = self.spec
        u, ages = self.queue.realize(t)
        valid = np.ones((self.P, self.L), bool)
        if not self.trace.always_on:
            ids = (np.asarray(client_ids) if client_ids is not None
                   else np.broadcast_to(np.arange(self.L) % self.K,
                                        (self.P, self.L)))
            valid &= u < self.trace.probs(t, self.K)[ids]
        valid &= ages <= spec.max_stale
        a = np.minimum(ages, spec.max_stale)
        s = valid * staleness_weights(torch.from_numpy(a),
                                      spec.alpha).numpy()
        self.buf_n += valid.sum(axis=1)
        # a flush needs a full buffer AND data to release this step (the
        # mesh step feeds the flush from the current batch only)
        flushed = (self.buf_n >= spec.buffer) & valid.any(axis=1)
        self.buf_n[flushed] = 0
        # release gating: zero weights until the flush
        s = s * flushed[:, None]
        wsum = s.sum(axis=1)
        weights = s * (self.L / np.maximum(wsum, 1e-12))[:, None]
        q = np.where(flushed,
                     np.minimum(1.0, valid.sum(axis=1) / self.K), 0.0)
        return (torch.as_tensor(weights, dtype=torch.float32,
                                device=self.device), flushed, q)
