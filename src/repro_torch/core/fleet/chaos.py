"""Chaos harness: kill k < P servers mid-run, prove the fleet recovers
(a copy of the reference's ``core/fleet/chaos.py``; the runs go through
the port's fleet, on ``cuda`` unless ``device`` says otherwise).

Two entry points:

:func:`plan_kills`
    realizes a :class:`~repro_torch.core.resilience.faults.FaultModel`'s
    ``outage ... kill=1`` component as a tick -> servers kill schedule,
    drawn from the SAME ``fault_stream_rng(seed, STREAM_TOPOLOGY, tick)``
    uniforms the simulated :class:`~repro_torch.core.resilience.process.
    TopologyProcess` consumes — a ``kill`` realization downs exactly the
    servers a masked realization would have downed, so the simulated and
    the process-level fault injections are the same experiment at two
    fidelities.

:func:`chaos_run`
    runs the faulted fleet and its unfaulted twin (same seeds, same
    cohorts — dispatch draws are pure in ``(seed, tick)``) and reports
    both trajectories plus the recovery ledger.  Acceptance: with
    ``k < P`` kills and elastic restart the faulted run converges to the
    same MSD neighborhood, and when every killed worker restores within
    the retry budget the run is *exactly* the unfaulted one (fold counts,
    release schedule and per-server q-ledgers identical — the tier-1
    chaos test).

Usage::

    from repro_torch.core.fleet import FleetProblem, chaos_run
    out = chaos_run(FleetProblem(P=4), "fleet:transport=filelog",
                    ticks=30, kill_at={9: [2]}, ckpt_root=tmpdir,
                    device="cuda")
    assert out.faulted.restarts >= 1
    assert abs(out.faulted.msd[-1] - out.clean.msd[-1]) < tol
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.fleet.coordinator import (FleetRunResult,
                                                reference_solution,
                                                run_fleet)
from repro_torch.core.fleet.spec import FleetSpec, parse_fleet_spec
from repro_torch.core.fleet.worker import FleetProblem
from repro_torch.core.resilience.faults import (STREAM_TOPOLOGY,
                                                FaultModel,
                                                fault_stream_rng,
                                                parse_fault_spec)


def plan_kills(fault: "FaultModel | str", P: int, ticks: int, *,
               seed: int = 0, max_down: Optional[int] = None
               ) -> Dict[int, list]:
    """tick -> [servers to SIGKILL], the process-level ``outage`` twin.

    Uses the topology stream's outage draw (``up = u >= outage``, the
    first P uniforms of the tick — the exact draw order of
    ``TopologyProcess._realize``), gated on ``outage_kill``.  ``max_down``
    caps simultaneous kills at ``P - 1`` by default: the chaos contract
    is k < P (a fully dead fleet has nothing to recover from).
    """
    f = parse_fault_spec(fault) if isinstance(fault, str) else fault
    if not f.outage_kill or f.outage <= 0:
        return {}
    cap = (P - 1) if max_down is None else min(max_down, P - 1)
    plan: Dict[int, list] = {}
    for t in range(ticks):
        rng = fault_stream_rng(seed, STREAM_TOPOLOGY, t)
        down = [p for p, u in enumerate(rng.random(P)) if u < f.outage]
        if down:
            plan[t] = down[:cap]
    return plan


@dataclass
class ChaosOutcome:
    """A faulted run and its unfaulted twin."""
    clean: FleetRunResult
    faulted: FleetRunResult
    kill_plan: Dict[int, list]

    @property
    def msd_gap(self) -> float:
        """|final faulted MSD - final clean MSD| (the convergence-
        neighborhood acceptance metric)."""
        return float(abs(self.faulted.msd[-1] - self.clean.msd[-1]))


def chaos_run(prob: FleetProblem, spec: "FleetSpec | str", *, ticks: int,
              ckpt_root: str, kill_at: Optional[Dict[int, list]] = None,
              fault: "FaultModel | str | None" = None,
              A: Optional[np.ndarray] = None,
              await_rejoin: bool = True, device=None) -> ChaosOutcome:
    """Run the unfaulted twin, then the killed run, under one w_ref.

    ``kill_at`` pins an explicit schedule (the deterministic tests /
    demo); ``fault`` derives one from an ``outage:p,kill=1`` spec via
    :func:`plan_kills`.  Separate checkpoint roots keep the two runs'
    write-ahead state apart.  ``await_rejoin`` (default on: the chaos
    contract wants exact recovery) barriers each killed tick on the
    elastic restart's hello so no tick is skipped; turn it off to
    measure degraded-topology behavior instead.  Both runs go on
    ``device`` (``cuda`` unless told otherwise).
    """
    device = resolve_device(device)
    if isinstance(spec, str):
        spec = parse_fleet_spec(spec)
    plan = dict(kill_at or {})
    if fault is not None:
        merged = plan_kills(fault, prob.P, ticks, seed=prob.seed)
        for t, servers in merged.items():
            plan.setdefault(t, []).extend(
                p for p in servers if p not in plan.get(t, []))
    w_ref = reference_solution(prob)
    clean = run_fleet(prob, spec, ticks, A=A, w_ref=w_ref,
                      ckpt_root=os.path.join(ckpt_root, "clean"),
                      device=device)
    faulted = run_fleet(prob, spec, ticks, A=A, w_ref=w_ref,
                        ckpt_root=os.path.join(ckpt_root, "faulted"),
                        kill_at={t: list(s) for t, s in plan.items()},
                        await_rejoin=await_rejoin, device=device)
    return ChaosOutcome(clean=clean, faulted=faulted, kill_plan=plan)
