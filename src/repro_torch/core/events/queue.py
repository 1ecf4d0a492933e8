"""Event arrival process: who arrives when, and how stale they are (port of
``repro.core.events.queue``).

An :class:`EventQueue` realizes the per-tick **event batches** the async
executor consumes.  Time advances in ticks; at tick ``t`` every server has
``E = AsyncSpec.events_per_tick`` candidate event slots.  Per candidate
event the queue realizes an **arrival uniform** ``u`` (the event fires iff
``u`` falls below the arriving client's availability intensity) and an
**age**, the floor of a :class:`~repro_torch.core.events.spec.LatencySpec`
draw.  Both are numpy draws from the resilience runtime's shared
:func:`~repro_torch.core.resilience.faults.fault_stream_rng` streams
(``STREAM_ARRIVAL``, ``STREAM_LATENCY``), copied from the reference, so
they equal its realizations bit for bit.

Client *identity* is drawn on the device (the cohort sampler), so the
identity-dependent part of the arrival test runs there too:
:func:`trace_intensity_fn` turns each trace kind into torch arithmetic.
Its tick comes from a device counter, as a captured round graph cannot
read a host int.  Diurnal is computed in float32, as the reference's
compiled tick computes it; devclass is a static [K] table made before
capture.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.events.spec import AsyncSpec
from repro_torch.core.population.cohort import AvailabilityTrace
from repro_torch.core.resilience.faults import (
    STREAM_ARRIVAL,
    STREAM_LATENCY,
    fault_stream_rng,
)


def trace_intensity_fn(trace: AvailabilityTrace, K: int, device=None
                       ) -> Optional[Callable]:
    """A trace's availability probabilities as torch arithmetic.

    Returns ``fn(t, idx) -> probs``: ``t`` the tick as an integer device
    tensor (0-d or [1]), ``idx`` an int64 tensor of client ids, ``probs``
    their float32 arrival intensities of ``idx``'s shape; or None for the
    ``always`` trace (intensity 1: the executor skips the arrival test).
    The formulas are ``AvailabilityTrace.probs``' evaluated per sampled id,
    in float32 (devclass: its [K] probabilities, made once on ``device``).
    """
    if trace.always_on:
        return None
    if trace.kind == "devclass":
        table = torch.as_tensor(trace.probs(0, K), dtype=torch.float32,
                                device=device)          # t-independent

        def devclass(t, idx):
            return table[idx]

        return devclass

    # the reference's ``lo + (1 - lo) * 0.5 * (1 + sin(2 pi (t / period +
    # (idx % period) / period)))`` as its compiled tick evaluates it in
    # float32: XLA turns each division by the period into a product with
    # the float32 reciprocal, folds 0.5 (1 - lo) into one constant, and
    # contracts a * b + c into a fused multiply-add (_fma)
    period = trace.period
    inv = float(np.float32(1.0) / np.float32(period))
    amp = float(np.float32(0.5) * np.float32(1.0 - trace.min_avail))
    lo = float(np.float32(trace.min_avail))
    two_pi = float(np.float32(2.0 * math.pi))

    def diurnal(t, idx):
        t_inv = t.to(torch.float32).reshape(()) * inv
        x = _fma((idx % period).to(torch.float32), inv, t_inv)
        return _fma(1.0 + torch.sin(x * two_pi), amp, lo)

    return diurnal


def _fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64, so only the sum rounds there before the
    one rounding to float32 (a fused multiply-add but for a double
    rounding one time in about 2^29)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


class EventQueue:
    """Deterministic per-tick event-batch realizations.

    ``realize(t)`` returns the tick's ``(arrival uniforms [P, E],
    ages [P, E])``; ``realize_horizon(T)`` stacks ``T`` ticks into the
    ``[T, P, E]`` arrays the ``scan=True`` executor copies to the device
    once.  Both are memo-free pure functions of ``(seed, t)``."""

    def __init__(self, P: int, spec: AsyncSpec, *, seed: int = 0):
        self.P = P
        self.spec = spec
        self.E = spec.events_per_tick
        self.seed = seed

    def realize(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        """(arrival uniforms [P, E] float32, ages [P, E] int32) of tick t."""
        shape = (self.P, self.E)
        u = fault_stream_rng(self.seed, STREAM_ARRIVAL, t).random(
            shape).astype(np.float32)
        ages = self.spec.latency.sample_ages(
            fault_stream_rng(self.seed, STREAM_LATENCY, t), shape)
        return u, ages

    def realize_horizon(self, T: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked ([T, P, E] uniforms, [T, P, E] ages) for a whole run."""
        us, ages = zip(*(self.realize(t) for t in range(T)))
        return np.stack(us), np.stack(ages)
