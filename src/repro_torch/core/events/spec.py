"""Async-executor specification: the ``GFLConfig.async_spec`` grammar (a
copy of the reference's ``core/events/spec.py``: pure numpy, parsed specs
and latency draws equal to the reference's bit for bit).

The event-driven engine (FedBuff-style semi-async; see docs/async.md) is
configured by a compact spec string so configs stay flat and hashable,
exactly like ``fault`` / ``cohort`` / ``population``::

    none
    async
    async:buffer=8
    async:buffer=8,latency=lognorm:0.5,max_stale=4
    async:buffer=8,latency=exp:1.5,max_stale=4,alpha=0.5,rate=16

Fields
  ``buffer``     per-server aggregation buffer: a server flushes (runs the
                 protocol's aggregation + combination for its row) once it
                 has folded this many client arrivals;
  ``latency``    per-event client latency distribution, in ticks (see
                 :class:`LatencySpec`); the floor of the draw is the AGE of
                 the arriving update — which past model snapshot the client
                 computed against;
  ``max_stale``  bounded staleness: arrivals older than this are refused
                 (the same bounded-staleness contract as
                 ``FaultModel.staleness`` — a contribution may not lag the
                 server by more than the bound);
  ``alpha``      staleness-weight exponent: contributions fold with weight
                 ``1/(1 + age)^alpha`` (FedBuff-style down-weighting);
  ``rate``       candidate arrival events per server per tick (the event
                 batch width); 0 means ``buffer`` — which, with zero
                 latency and an always-on trace, is the synchronous
                 lockstep limit.

The **sync limit** ``buffer == rate``, ``latency == zero``,
``max_stale == 0`` is the synchronous protocol: every server's buffer
fills every tick with age-0 updates, so every tick is a lockstep round.
The executor routes that case through the population engine's exact pure
path — bit-identity is by construction, not by parallel code
(tests/test_torch_events.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_LATENCY_KINDS = ("zero", "fixed", "exp", "lognorm")


@dataclass(frozen=True)
class LatencySpec:
    """Per-event client latency distribution, in ticks.

    ``zero``          every update arrives within its dispatch tick (age 0);
    ``fixed:<k>``     constant latency of k ticks;
    ``exp:<mean>``    exponential with the given mean;
    ``lognorm:<s>``   lognormal with log-std s and median 1 tick.
    """
    kind: str = "zero"
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in _LATENCY_KINDS:
            raise ValueError(f"unknown latency kind {self.kind!r}; "
                             f"expected one of {_LATENCY_KINDS}")
        if self.kind != "zero" and self.param < 0:
            raise ValueError(f"latency parameter must be >= 0, "
                             f"got {self.param}")

    @property
    def is_zero(self) -> bool:
        return self.kind == "zero" or (self.kind == "fixed"
                                       and self.param == 0)

    def sample_ages(self, rng: np.random.Generator, size) -> np.ndarray:
        """Integer ages (floor of the latency draw), >= 0."""
        if self.kind == "zero":
            return np.zeros(size, np.int32)
        if self.kind == "fixed":
            return np.full(size, int(self.param), np.int32)
        if self.kind == "exp":
            draws = rng.exponential(self.param, size)
        else:  # lognorm: median 1 tick, log-std = param
            draws = rng.lognormal(0.0, self.param, size)
        return np.floor(draws).astype(np.int32)

    def to_spec(self) -> str:
        """Inverse of :func:`parse_latency_spec` (canonical form)."""
        if self.kind == "zero":
            return "zero"
        return f"{self.kind}:{self.param:g}"


def parse_latency_spec(spec: str) -> LatencySpec:
    """``zero`` | ``fixed:<k>`` | ``exp:<mean>`` | ``lognorm:<sigma>``."""
    spec = (spec or "zero").strip()
    name, sep, arg = spec.partition(":")
    if name not in _LATENCY_KINDS:
        raise ValueError(f"unknown latency kind {name!r} in {spec!r}; "
                         f"expected one of {_LATENCY_KINDS}")
    if name == "zero":
        if sep:
            raise ValueError(f"latency kind 'zero' takes no argument "
                             f"(got {spec!r})")
        return LatencySpec()
    if not sep or not arg:
        raise ValueError(f"latency kind {name!r} needs an argument, e.g. "
                         f"'{name}:0.5' (got {spec!r})")
    try:
        param = float(arg)
    except ValueError:
        raise ValueError(
            f"bad latency parameter {arg!r} in {spec!r}") from None
    return LatencySpec(kind=name, param=param)


@dataclass(frozen=True)
class AsyncSpec:
    """Parsed ``GFLConfig.async_spec`` (see module docstring)."""
    buffer: int = 8
    latency: LatencySpec = LatencySpec()
    max_stale: int = 0
    alpha: float = 0.5
    rate: int = 0          # candidate events per server per tick; 0 = buffer

    def __post_init__(self):
        if self.buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {self.buffer}")
        if self.max_stale < 0:
            raise ValueError(f"max_stale must be >= 0, got {self.max_stale}")
        if self.alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")

    @property
    def events_per_tick(self) -> int:
        """The event batch width E (``rate``, defaulting to ``buffer``)."""
        return self.rate or self.buffer

    @property
    def is_sync_limit(self) -> bool:
        """True when every tick is a lockstep synchronous round: the buffer
        fills exactly every tick (rate == buffer) with zero-latency, age-0
        arrivals and no staleness slack."""
        return (self.events_per_tick == self.buffer
                and self.latency.is_zero and self.max_stale == 0)

    def to_spec(self) -> str:
        """Inverse of :func:`parse_async_spec` (canonical form)."""
        parts = [f"buffer={self.buffer}"]
        if not self.latency.is_zero:
            parts.append(f"latency={self.latency.to_spec()}")
        if self.max_stale:
            parts.append(f"max_stale={self.max_stale}")
        if self.alpha != 0.5:
            parts.append(f"alpha={self.alpha:g}")
        if self.rate:
            parts.append(f"rate={self.rate}")
        return "async:" + ",".join(parts)


def parse_async_spec(spec: str) -> "AsyncSpec | None":
    """Parse ``GFLConfig.async_spec``; ``"none"`` returns None.

    Grammar: ``async[:key=value,...]`` with keys ``buffer`` (int),
    ``latency`` (a :func:`parse_latency_spec` string — its own ``:`` is
    part of the value), ``max_stale`` (int), ``alpha`` (float), ``rate``
    (int).
    """
    spec = (spec or "none").strip()
    if spec == "none":
        return None
    name, _, rest = spec.partition(":")
    if name != "async":
        raise ValueError(f"bad async spec {spec!r}; expected 'none' or "
                         "'async[:buffer=..,latency=..,max_stale=..,"
                         "alpha=..,rate=..]'")
    kw: dict = {}
    conv = {"buffer": int, "max_stale": int, "rate": int, "alpha": float,
            "latency": parse_latency_spec}
    for part in filter(None, rest.split(",")):
        k, sep, v = part.partition("=")
        if not sep or k not in conv:
            raise ValueError(
                f"unknown argument {part!r} in async spec {spec!r}; "
                f"expected key=value with key in {sorted(conv)}")
        if k in kw:
            raise ValueError(f"duplicate argument {k!r} in async spec "
                             f"{spec!r}")
        try:
            kw[k] = conv[k](v)
        except ValueError as e:
            raise ValueError(
                f"bad value {v!r} for {k!r} in async spec {spec!r}: {e}"
            ) from None
    return AsyncSpec(**kw)
