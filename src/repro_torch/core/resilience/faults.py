"""Fault-model specification for the resilience runtime (a copy of the
reference's ``core/resilience/faults.py``: pure numpy, realizations equal
bit for bit).

The paper motivates the graph-federated architecture with robustness: "the
current architecture of a server connected to multiple clients is highly
sensitive to communication failures and computational overloads at the
server".  A :class:`FaultModel` makes that regime testable — it names the
per-round failure processes the :class:`~repro_torch.core.resilience.process.
TopologyProcess` realizes:

  ``link_drop``       i.i.d. per-edge link failures (each surviving base
                      edge drops with this probability, independently per
                      round — the arXiv:2203.07105 random-A_i regime);
  ``outage``          correlated server outages: a down server loses ALL
                      incident links at once for the round;
  ``straggler``       computational overload: a straggling server skips the
                      round's client work and re-announces its most recent
                      psi, up to ``staleness`` consecutive rounds;
  ``client_dropout``  per-(server, client) mid-round dropout — the case
                      that breaks naive secure aggregation (see
                      docs/resilience.md and secure_agg dropout recovery).

Specs are compact strings stored in ``GFLConfig.fault`` so configs stay
flat and hashable::

    none
    links:0.1
    outage:0.05
    outage:0.05,kill=1
    straggler:0.2,stale=3
    dropout:0.25
    links:0.1+outage:0.02+straggler:0.1,stale=2+dropout:0.2

Components are joined with ``+``; each is ``name:<prob>`` with optional
``,key=value`` arguments (``straggler`` takes ``stale``; ``outage`` takes
``kill`` — ``kill=1`` asks the fleet runtime to realize the drawn outages
as real worker-process SIGKILLs: the kill schedule is
:func:`repro_torch.core.fleet.chaos.plan_kills`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_COMPONENTS = ("links", "outage", "straggler", "dropout")

# named streams of the per-round fault/availability realizations; every
# consumer MUST draw through fault_stream_rng so realizations agree across
# components (e.g. a CohortScheduler and a TopologyProcess sharing a seed
# realize identical client-dropout masks — stream 3)
STREAM_TOPOLOGY = 1
STREAM_STRAGGLER = 2
STREAM_DROPOUT = 3
STREAM_AVAILABILITY = 4
STREAM_ARRIVAL = 5    # event engine: per-event arrival uniforms
STREAM_LATENCY = 6    # event engine: per-event latency/age draws


def fault_stream_rng(seed: int, stream: int, round_idx: int
                     ) -> np.random.Generator:
    """Deterministic per-(seed, stream, round) generator shared by every
    host-side fault realization (TopologyProcess, CohortScheduler).
    Streams keep the topology / straggler / dropout / availability draws
    independent while staying pure functions of (seed, round)."""
    return np.random.default_rng((0x5EED, seed, stream, int(round_idx)))


def client_dropout_mask(seed: int, round_idx: int, P: int, L: int,
                        dropout: float) -> np.ndarray:
    """[P, L] participation mask for the round's sampled clients — THE
    dropout realization, shared by ``TopologyProcess.client_alive`` and
    ``CohortScheduler.client_alive`` so both sides of the contract (fault
    execution and cohort accounting) see identical masks for a seed.

    Each sampled client drops with probability ``dropout``; at least one
    client per server always survives (a server whose whole cohort
    vanished has nothing to aggregate and simply re-runs the round —
    modeled as one forced survivor)."""
    rng = fault_stream_rng(seed, STREAM_DROPOUT, round_idx)
    alive = rng.random((P, L)) >= dropout
    dead_rows = ~alive.any(axis=1)
    if dead_rows.any():
        survivor = rng.integers(0, L, size=P)
        alive[dead_rows, survivor[dead_rows]] = True
    return alive


@dataclass(frozen=True)
class FaultModel:
    """Per-round failure probabilities (all independent across rounds)."""
    link_drop: float = 0.0       # i.i.d. per-edge drop probability
    outage: float = 0.0          # per-server correlated outage probability
    outage_kill: bool = False    # realize outages as real worker SIGKILLs
                                 # (core/fleet chaos) instead of A-row masks
    straggler: float = 0.0       # per-server straggler probability
    staleness: int = 1           # max consecutive rounds a straggler may
                                 # reuse the same stale psi
    client_dropout: float = 0.0  # per-(server, client) dropout probability

    def __post_init__(self):
        for name in ("link_drop", "outage", "straggler", "client_dropout"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"fault probability {name}={p} not in [0, 1]")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")

    @property
    def is_null(self) -> bool:
        """True when no failure process is active (probabilities all 0)."""
        return (self.link_drop == 0.0 and self.outage == 0.0
                and self.straggler == 0.0 and self.client_dropout == 0.0)

    @property
    def perturbs_topology(self) -> bool:
        """True when the effective combination matrix varies round-to-round."""
        return self.link_drop > 0.0 or self.outage > 0.0

    def to_spec(self) -> str:
        """Inverse of :func:`parse_fault_spec` (canonical form)."""
        parts = []
        if self.link_drop:
            parts.append(f"links:{self.link_drop:g}")
        if self.outage:
            parts.append(f"outage:{self.outage:g}"
                         + (",kill=1" if self.outage_kill else ""))
        if self.straggler:
            parts.append(f"straggler:{self.straggler:g},stale={self.staleness}")
        if self.client_dropout:
            parts.append(f"dropout:{self.client_dropout:g}")
        return "+".join(parts) or "none"


def parse_fault_spec(spec: str) -> FaultModel:
    """Parse a ``GFLConfig.fault`` string into a :class:`FaultModel`."""
    spec = (spec or "none").strip()
    if spec == "none":
        return FaultModel()
    kw: dict = {}
    for part in spec.split("+"):
        name, sep, rest = part.strip().partition(":")
        if name not in _COMPONENTS or not sep:
            raise ValueError(
                f"bad fault component {part!r} in spec {spec!r}; expected "
                f"'name:prob[,key=value]' with name in {_COMPONENTS}")
        prob_str, *args = rest.split(",")
        try:
            prob = float(prob_str)
        except ValueError:
            raise ValueError(
                f"bad probability {prob_str!r} in fault component {part!r}"
            ) from None
        field = {"links": "link_drop", "outage": "outage",
                 "straggler": "straggler", "dropout": "client_dropout"}[name]
        if field in kw:
            raise ValueError(f"duplicate fault component {name!r} in {spec!r}")
        kw[field] = prob
        for arg in args:
            k, sep, v = arg.partition("=")
            if name == "straggler" and k == "stale" and sep:
                kw["staleness"] = int(v)
            elif name == "outage" and k == "kill" and sep:
                # kill realization: the fleet SIGKILLs the drawn servers'
                # worker processes (repro_torch.core.fleet.chaos.
                # plan_kills) instead of masking their rows of A
                kw["outage_kill"] = bool(int(v))
            else:
                raise ValueError(
                    f"unknown argument {arg!r} for fault component {name!r}")
    return FaultModel(**kw)
