"""Central registry of the spec-string grammars (port of
``repro.core.specs``: the same eight grammars and examples, over the
port's own parsers).

Every config surface in this repo that is a compact spec string —
faults, availability traces, cohort schedules, client populations,
event-layer latency/async specs, fleet deployments, watch rules — has a
``parse`` function and a ``to_spec`` inverse, defined beside what it
configures (``resilience/faults.py``, ``population/cohort.py``,
``population/population.py``, ``events/spec.py``, ``fleet/spec.py``,
``telemetry/watch.py``); the registry maps
``name -> (parse, to_spec, examples)`` so tooling can *enumerate* the
grammars: the round-trip tests drive :func:`all_grammars`, so a newly
registered grammar is inverse-tested automatically.

Round-trip law (canonical-form, both directions)::

    parse(to_spec(parse(s))) == parse(s)     for every valid spec s
    to_spec(parse(c)) == c                   for canonical c = to_spec(...)
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

from repro_torch.core.events.spec import parse_async_spec, parse_latency_spec
from repro_torch.core.fleet.spec import parse_fleet_spec
from repro_torch.core.population.cohort import (cohort_to_spec,
                                                parse_cohort_spec,
                                                parse_trace_spec)
from repro_torch.core.population.population import (parse_population_spec,
                                                    population_to_spec)
from repro_torch.core.resilience.faults import parse_fault_spec
from repro_torch.telemetry.watch import parse_watch_spec, watch_to_spec


class SpecGrammar(NamedTuple):
    """One spec-string grammar: a parse/serialize pair plus canonical
    example specs (used by the registry-driven round-trip tests)."""
    name: str
    parse: Callable[[str], object]
    to_spec: Callable[[object], str]
    examples: Sequence[str]


_REGISTRY: Dict[str, SpecGrammar] = {}


def register_grammar(name: str, parse, to_spec, examples=()) -> SpecGrammar:
    if name in _REGISTRY:
        raise ValueError(f"spec grammar {name!r} already registered")
    g = SpecGrammar(name, parse, to_spec, tuple(examples))
    _REGISTRY[name] = g
    return g


def get_grammar(name: str) -> SpecGrammar:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown spec grammar {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def all_grammars() -> Dict[str, SpecGrammar]:
    return dict(_REGISTRY)


register_grammar(
    "fault", parse_fault_spec, lambda m: m.to_spec(),
    examples=("none", "links:0.1", "links:0.1+dropout:0.2",
              "outage:0.05,kill=1",
              "straggler:0.3,stale=2+dropout:0.1"))

register_grammar(
    "trace", parse_trace_spec, lambda t: t.to_spec(),
    examples=("always", "diurnal,period=24,min=0.2",
              "devclass,slow=0.5,p=0.3"))

# parse_cohort_spec returns the (sampler, floor, trace) tuple the
# scheduler consumes; the serializer takes the same tuple back
register_grammar(
    "cohort", parse_cohort_spec, lambda t: cohort_to_spec(*t),
    examples=("uniform", "importance,floor=0.2",
              "uniform+trace:diurnal,period=24,min=0.2",
              "importance,floor=0.05+trace:devclass,slow=0.5,p=0.3"))

register_grammar(
    "population", parse_population_spec, population_to_spec,
    examples=("dense", "synthetic:iid,sigma=1.0",
              "synthetic:hetero,hi=1.5,lo=0.5",
              "synthetic:mixture,clusters=4,drift=0.5",
              "dirichlet:0.3,pool=4000"))

register_grammar(
    "latency", parse_latency_spec, lambda ls: ls.to_spec(),
    examples=("zero", "fixed:2", "exp:1.5", "lognorm:0.5"))

# "none" -> None is part of the async grammar: an absent event layer
# round-trips through the same channel as a configured one
register_grammar(
    "async", parse_async_spec,
    lambda a: "none" if a is None else a.to_spec(),
    examples=("none", "async:buffer=8,latency=lognorm:0.5,max_stale=4",
              "async:buffer=4,latency=fixed:2,alpha=0.5"))

# multi-process fleet deployments (core/fleet; the grammar is ported
# ahead of the fleet itself): transport substrate,
# retry/backoff budget, heartbeat cadence, checkpoint cadence
register_grammar(
    "fleet", parse_fleet_spec, lambda s: s.to_spec(),
    examples=("fleet", "fleet:transport=filelog",
              "fleet:transport=socket,retry=3,timeout=2.0,backoff=exp",
              "fleet:retry=5,timeout=0.5,backoff=const,heartbeat=0.2,"
              "ckpt_every=2"))

# live-monitor alert rules (telemetry/watch.py): eps-budget exhaustion,
# spectral-gap collapse, NaN trajectories, exploding norms, staleness,
# throughput drop vs trailing window
register_grammar(
    "watch", parse_watch_spec, watch_to_spec,
    examples=("nan", "eps:0.9,target=4", "gap:0.05+nan+norm:100",
              "stale:4+throughput:0.5,window=20", "restart:2+nan"))
