"""Cohort scheduling: who participates in round i, and at what rate — port
of ``repro.core.population.cohort``.

A :class:`CohortScheduler` draws each round's ``[P, L]`` cohort from three
processes:

  1. an **availability trace**: per-client availability probabilities
     (diurnal phases, device classes), realized on the host in numpy,
     deterministic in ``(seed, round)`` and equal to the reference's bit
     for bit (``fault_stream_rng``'s availability stream);
  2. the **sampler**: uniform, or the importance sampler of
     :mod:`repro_torch.core.sampling`, drawing WITH replacement so the
     1/(K pi) reweighting stays unbiased, on the run's device;
  3. **mid-round dropout** from the ``dropout:`` component of
     ``GFLConfig.fault``, the same masks as
     ``TopologyProcess.client_alive`` for a shared seed.

It also gives each round's realized sampling rate q, against which
subsampling amplification is charged (``PrivacyAccountant.
amplified_epsilon``): L / K on the pure path, min(1, L / min_p K_avail)
under a trace, min(1, L max_k pi_k) under importance sampling.  The
reference syncs q to the host every round; here a weighted round's q is a
float64 device scalar, which the engine records into a [T] trace and
copies once a run (``q_history`` gains the trace then).

``uniform`` with the ``always`` trace is the *pure* path, the dense
simulator's own draw (``pure``); the rest is the weighted path.

Specs live in ``GFLConfig.cohort``::

    uniform
    importance,floor=0.1
    uniform+trace:diurnal,period=24,min=0.2
    importance+trace:devclass,slow=0.4,p=0.3
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import sampling as IS
from repro_torch.core.resilience.faults import (
    STREAM_AVAILABILITY,
    FaultModel,
    client_dropout_mask,
    fault_stream_rng,
    parse_fault_spec,
)

_TRACES = ("always", "diurnal", "devclass")


@dataclass(frozen=True)
class AvailabilityTrace:
    """Per-client availability probabilities as a function of the round.

    ``always``    every client available every round (prob 1);
    ``diurnal``   sinusoidal day/night pattern: client k's phase is
                  ``(k mod period) / period``, availability in [min, 1];
    ``devclass``  two device classes: a ``slow`` fraction of clients
                  (chosen by a golden-ratio hash of k, not by id order) is
                  available with probability ``p``, the rest always.
    """
    kind: str = "always"
    period: int = 24        # diurnal: rounds per simulated day
    min_avail: float = 0.2  # diurnal: trough availability
    slow_frac: float = 0.3  # devclass: fraction of constrained clients
    slow_p: float = 0.5     # devclass: their availability probability

    def __post_init__(self):
        if self.kind not in _TRACES:
            raise ValueError(f"unknown availability trace {self.kind!r}; "
                             f"expected one of {_TRACES}")

    @property
    def always_on(self) -> bool:
        return self.kind == "always"

    def probs(self, round_idx: int, K: int) -> np.ndarray:
        """[K] availability probabilities for this round."""
        k = np.arange(K)
        if self.kind == "always":
            return np.ones(K)
        if self.kind == "diurnal":
            phase = (k % self.period) / self.period
            wave = 0.5 * (1.0 + np.sin(
                2.0 * np.pi * (round_idx / self.period + phase)))
            return self.min_avail + (1.0 - self.min_avail) * wave
        # devclass: golden-ratio hash decorrelates class from client id
        u = ((k * 2654435761) % (1 << 32)) / float(1 << 32)
        return np.where(u < self.slow_frac, self.slow_p, 1.0)

    def to_spec(self) -> str:
        """Inverse of :func:`parse_trace_spec` (canonical form)."""
        if self.kind == "always":
            return "always"
        if self.kind == "diurnal":
            return f"diurnal,period={self.period},min={self.min_avail:g}"
        return f"devclass,slow={self.slow_frac:g},p={self.slow_p:g}"


def parse_trace_spec(spec: str) -> AvailabilityTrace:
    """``always`` | ``diurnal[,period=..][,min=..]`` |
    ``devclass[,slow=..][,p=..]``."""
    name, *parts = (spec or "always").strip().split(",")
    kw: dict = {}
    keys = {"diurnal": {"period": ("period", int), "min": ("min_avail", float)},
            "devclass": {"slow": ("slow_frac", float), "p": ("slow_p", float)},
            "always": {}}
    if name not in keys:
        raise ValueError(f"unknown availability trace {name!r}; "
                         f"expected one of {_TRACES}")
    for part in parts:
        k, sep, v = part.partition("=")
        if not sep or k not in keys[name]:
            raise ValueError(
                f"unknown argument {part!r} for trace {name!r}")
        fname, conv = keys[name][k]
        kw[fname] = conv(v)
    return AvailabilityTrace(kind=name, **kw)


def parse_cohort_spec(spec: str):
    """``sampler[+trace:<trace spec>]`` -> (sampler, floor, trace)."""
    spec = (spec or "uniform").strip()
    trace = AvailabilityTrace()
    sampler, floor = "uniform", 0.1
    for part in spec.split("+"):
        part = part.strip()
        if part.startswith("trace:"):
            trace = parse_trace_spec(part[len("trace:"):])
            continue
        name, *args = part.split(",")
        if name not in ("uniform", "importance"):
            raise ValueError(
                f"bad cohort component {part!r} in spec {spec!r}; expected "
                "'uniform' or 'importance[,floor=f]' plus optional "
                "'trace:<spec>'")
        sampler = name
        for a in args:
            k, sep, v = a.partition("=")
            if name == "importance" and k == "floor" and sep:
                floor = float(v)
            else:
                raise ValueError(
                    f"unknown argument {a!r} for cohort sampler {name!r}")
    return sampler, floor, trace


def cohort_to_spec(sampler: str, floor: float,
                   trace: AvailabilityTrace) -> str:
    """Inverse of :func:`parse_cohort_spec` (canonical form): the floor is
    an importance-sampler knob and is only serialized there."""
    if sampler == "importance":
        out = f"importance,floor={floor:g}"
    elif sampler == "uniform":
        out = "uniform"
    else:
        raise ValueError(f"unknown cohort sampler {sampler!r}")
    if not trace.always_on:
        out += "+trace:" + trace.to_spec()
    return out


class CohortSelection(NamedTuple):
    """One round's realized cohort, on the run's device.  The reference
    draws the minibatch indices in its round function; here they come from
    the same draw of the ``cohort`` stream as the clients."""
    client_idx: torch.Tensor          # [P, L] population client ids
    batch_idx: torch.Tensor           # [P, L, B] sample ids per client
    weights: Optional[torch.Tensor]   # [P, L] unbiased 1/(K pi); None = 1
    alive: Optional[torch.Tensor]     # [P, L] bool dropout mask; None = all
    q: object                         # realized rate: a float on the pure
                                      # path, else a float64 device scalar


class CohortScheduler:
    """Draws per-round cohorts; owns the IS state and the realized-q ledger.

    The host side (availability and dropout realizations) is deterministic
    in ``(seed, round)``; the run's :class:`~repro_torch.draws.Draws` drive
    the client draws.  The IS state lives on the run's device
    (:meth:`place`) and :meth:`observe` updates it in place, so a captured
    round graph keeps reading it at one address."""

    def __init__(self, K: int, L: int, P: int, *, sampler: str = "uniform",
                 floor: float = 0.1, trace: AvailabilityTrace | str = "always",
                 fault: FaultModel | str = "none", seed: int = 0):
        if not 1 <= L <= K:
            raise ValueError(f"cohort size L={L} not in [1, K={K}]")
        if sampler not in ("uniform", "importance"):
            raise ValueError(f"unknown cohort sampler {sampler!r}")
        self.K, self.L, self.P = K, L, P
        self.sampler = sampler
        self.floor = floor
        self.trace = (parse_trace_spec(trace) if isinstance(trace, str)
                      else trace)
        self.fault = (parse_fault_spec(fault) if isinstance(fault, str)
                      else fault)
        self.seed = seed
        self.is_state = (IS.init_is_state(P, K) if sampler == "importance"
                         else None)
        self.q_history: list = []

    @classmethod
    def from_config(cls, cfg, *, K: Optional[int] = None,
                    L: Optional[int] = None) -> "CohortScheduler":
        sampler, floor, trace = parse_cohort_spec(cfg.cohort)
        K = K or cfg.clients_per_server
        return cls(K, L or cfg.clients_sampled or K, cfg.num_servers,
                   sampler=sampler, floor=floor, trace=trace,
                   fault=cfg.fault, seed=cfg.topology_seed)

    @property
    def pure(self) -> bool:
        """True when the cohort is exactly the dense simulator's uniform
        draw without replacement."""
        return self.sampler == "uniform" and self.trace.always_on

    def place(self, device) -> None:
        """Move the IS state to ``device`` (a no-op when it is there)."""
        if self.is_state is not None:
            self.is_state = IS.ISState(
                *(t.to(device) for t in self.is_state))

    # ------------------------------------------------------- realizations

    def availability(self, round_idx: int) -> np.ndarray:
        """[P, K] bool availability mask for the round (all True under the
        ``always`` trace).  At least one client per server is forced
        available: a server with no candidate cannot run."""
        if self.trace.always_on:
            return np.ones((self.P, self.K), bool)
        probs = self.trace.probs(round_idx, self.K)
        rng = fault_stream_rng(self.seed, STREAM_AVAILABILITY, round_idx)
        avail = rng.random((self.P, self.K)) < probs[None, :]
        dead = ~avail.any(axis=1)
        if dead.any():
            forced = rng.integers(0, self.K, size=self.P)
            avail[dead, forced[dead]] = True
        return avail

    def client_alive(self, round_idx: int) -> Optional[np.ndarray]:
        """[P, L] mid-round dropout mask over the sampled cohort, or None
        when the fault spec has no dropout component; the same realization
        as ``TopologyProcess.client_alive`` for a shared seed."""
        if self.fault.client_dropout <= 0:
            return None
        return client_dropout_mask(self.seed, round_idx, self.P, self.L,
                                   self.fault.client_dropout)

    # ---------------------------------------------------------- selection

    def effective_probs(self, avail: torch.Tensor) -> torch.Tensor:
        """[P, K] sampling probabilities masked by availability ([P, K]
        bool on the run's device), rows renormalized."""
        if self.sampler == "importance":
            base = IS.sampling_probs(self.is_state, floor=self.floor)
        else:
            base = torch.full((self.P, self.K), 1.0 / self.K,
                              dtype=torch.float32, device=avail.device)
        eff = base * avail.to(torch.float32)
        return eff / eff.sum(dim=1, keepdim=True)

    def select(self, draws, round_idx: int, *, N: int,
               batch_size: int) -> CohortSelection:
        """Draw round ``round_idx``'s cohort and its minibatch indices (N
        samples a client, ``batch_size`` of them each).  On the pure path
        this is the dense simulator's draw, weights None and q = L / K."""
        alive = self.client_alive(round_idx)
        alive_t = (None if alive is None else
                   torch.from_numpy(alive).to(draws.device))
        if self.pure:
            idx, bidx = draws.cohort(round_idx, self.P, self.K, N, self.L,
                                     batch_size)
            return CohortSelection(idx, bidx, None, alive_t,
                                   self.L / self.K)
        avail = torch.from_numpy(self.availability(round_idx)).to(
            draws.device)
        return self.weighted(draws, round_idx, avail, alive_t, N=N,
                             batch_size=batch_size)

    def weighted(self, draws, round_idx: int, avail: torch.Tensor,
                 alive: Optional[torch.Tensor], *, N: int,
                 batch_size: int) -> CohortSelection:
        """The weighted path's device part of :meth:`select`, on a realized
        availability mask ``avail`` [P, K] and dropout mask ``alive``: the
        clients drawn with replacement from the effective probabilities,
        their 1/(K_avail pi) weights and the round's q.  Reads no host
        value, so the round graph captures it on its staged buffers."""
        probs = self.effective_probs(avail)
        idx, bidx = draws.weighted_cohort(round_idx, probs, N, self.L,
                                          batch_size)
        k_avail = avail.sum(dim=1)
        weights = IS.importance_weights(probs, idx,
                                        k_norm=k_avail.to(torch.float32))
        if self.sampler == "importance":
            q = self.L * probs.max().to(torch.float64)
        else:
            q = self.L / k_avail.min().to(torch.float64)
        return CohortSelection(idx, bidx, weights, alive,
                               torch.clamp(q, max=1.0))

    def observe(self, client_idx: torch.Tensor,
                grad_norms: torch.Tensor) -> None:
        """Feed observed per-client gradient norms back into the importance
        sampler, in place (a no-op for the uniform sampler)."""
        if self.is_state is not None:
            new = IS.update_norm_estimates(self.is_state, client_idx,
                                           grad_norms)
            for dst, src in zip(self.is_state, new):
                dst.copy_(src)

    @property
    def realized_q(self) -> float:
        """Mean realized per-round sampling rate of the runs so far (1.0
        before any: the conservative no-amplification answer)."""
        return float(np.mean(self.q_history)) if self.q_history else 1.0
