"""Live run monitor: tail telemetry JSONL, evaluate alert rules (a copy
of ``repro.telemetry.watch``).

    python -m repro_torch.telemetry.watch RUN.jsonl --rules "eps:0.9,target=4+nan"
    python -m repro_torch.telemetry.watch RUN.jsonl --rules nan+gap:0.05 --once

The recorder half of observability writes the streams; this is
the *judging* half for a run in flight: it follows the canonical JSONL
sink output and evaluates a rule set over the ``round`` / ``step`` /
``privacy`` / ``mesh`` records as they land.  Rules are a spec-string
grammar (registered as ``watch`` in :mod:`repro_torch.core.specs`, round-trip
tested like fault/cohort/async):

``eps:FRAC[,target=EPS]``   privacy-budget exhaustion: composed ``eps``
                            >= FRAC * epsilon_target (``target=`` in the
                            rule, else ``--epsilon-target``)
``gap:MIN``                 spectral-gap collapse: ``gap`` < MIN
                            (round/mesh streams — mixing dying is the
                            paper's convergence killer)
``nan``                     any non-finite numeric in round/step/mesh
                            records (NaN/exploding trajectories; the
                            privacy stream is exempt — eps = inf is a
                            meaningful ledger state)
``norm:MAX``                exploding updates: ``update_norm`` /
                            ``grad_norm_max`` > MAX
``stale:BOUND``             staleness above the declared bound
``throughput:FRAC[,window=N]``  events-per-record drops below FRAC of
                            the trailing-window mean (default N=20)
``restart:N``               fleet churn: cumulative elastic worker
                            restarts (``fleet`` stream, core/fleet)
                            exceed N — a fleet that keeps losing workers
                            is failing even if every tick recovers

Alerts go to the console (stderr) and optionally an alerts JSONL
(``--alerts``); ``--once`` reads the whole file, prints a summary and
exits 1 iff any alert fired — the CI nightly smokes assert exit 0 over
the instrumented population/async runs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

# streams the nan rule scans (privacy exempt: eps=inf is meaningful)
_NAN_STREAMS = ("round", "step", "mesh")
_RULE_KINDS = ("eps", "gap", "nan", "norm", "stale", "throughput",
               "restart")


class WatchRule(NamedTuple):
    """One alert rule: a kind plus its (sorted, canonical) parameters."""
    kind: str
    params: Tuple[Tuple[str, float], ...] = ()

    def param(self, name: str, default=None):
        for k, v in self.params:
            if k == name:
                return v
        return default

    def to_spec(self) -> str:
        primary = {"eps": "frac", "gap": "min", "norm": "max",
                   "stale": "bound", "throughput": "frac",
                   "restart": "max"}.get(self.kind)
        head = self.kind
        rest = []
        for k, v in self.params:
            if k == primary:
                head = f"{self.kind}:{_fmt_num(v)}"
            else:
                rest.append(f"{k}={_fmt_num(v)}")
        return ",".join([head] + sorted(rest))


def _fmt_num(v: float) -> str:
    if float(v) == int(v):
        return str(int(v))
    return format(float(v), "g")


def parse_watch_spec(spec: str) -> Tuple[WatchRule, ...]:
    """``+``-separated watch rules -> canonical :class:`WatchRule` tuple.

    Grammar: ``kind[:value][,key=value,...]`` per rule; see the module
    docstring for the rule kinds.  Raises ``ValueError`` on unknown
    kinds, missing required values, or unknown parameters.
    """
    rules: List[WatchRule] = []
    for part in (p.strip() for p in spec.split("+")):
        if not part:
            continue
        head, *kvs = part.split(",")
        kind, _, value = head.partition(":")
        if kind not in _RULE_KINDS:
            raise ValueError(f"unknown watch rule {kind!r}; expected one "
                             f"of {_RULE_KINDS}")
        primary = {"eps": "frac", "gap": "min", "norm": "max",
                   "stale": "bound", "throughput": "frac",
                   "restart": "max"}.get(kind)
        params: Dict[str, float] = {}
        if value:
            if primary is None:
                raise ValueError(f"watch rule {kind!r} takes no value")
            params[primary] = float(value)
        elif primary is not None:
            raise ValueError(f"watch rule {kind!r} needs a value "
                             f"({kind}:<{primary}>)")
        allowed_kw = {"eps": ("target",),
                      "throughput": ("window",)}.get(kind, ())
        for kv in kvs:
            k, eq, v = kv.partition("=")
            if not eq or k not in allowed_kw:
                raise ValueError(f"watch rule {kind!r} does not take "
                                 f"parameter {kv!r}")
            params[k] = float(v)
        if kind == "throughput":
            params.setdefault("window", 20.0)
        rules.append(WatchRule(kind, tuple(sorted(params.items()))))
    if not rules:
        raise ValueError("empty watch spec")
    return tuple(rules)


def watch_to_spec(rules: Tuple[WatchRule, ...]) -> str:
    return "+".join(r.to_spec() for r in rules)


class Watcher:
    """Evaluates a watch rule set over a stream of enveloped records."""

    def __init__(self, rules: Tuple[WatchRule, ...],
                 epsilon_target: Optional[float] = None):
        self.rules = tuple(rules)
        self.epsilon_target = epsilon_target
        self.alerts: List[dict] = []
        self.records_seen = 0
        windows = [int(r.param("window", 20)) for r in self.rules
                   if r.kind == "throughput"]
        self._events: deque = deque(maxlen=max(windows) if windows else 1)

    # -- per-rule predicates -------------------------------------------

    def _check_eps(self, rule, rec) -> Optional[dict]:
        if rec.get("stream") != "privacy":
            return None
        eps = rec.get("eps")
        target = rule.param("target", self.epsilon_target)
        if (not _num(eps) or not math.isfinite(eps)
                or target is None or not math.isfinite(target)):
            return None
        frac = rule.param("frac")
        if eps >= frac * target:
            return {"message": f"eps_spent {eps:.4g} >= {frac:g} * "
                               f"epsilon_target {target:g}",
                    "value": eps}
        return None

    def _check_gap(self, rule, rec) -> Optional[dict]:
        if rec.get("stream") not in ("round", "mesh"):
            return None
        gap = rec.get("gap")
        if _num(gap) and math.isfinite(gap) and gap < rule.param("min"):
            return {"message": f"spectral gap {gap:.4g} < collapse "
                               f"threshold {rule.param('min'):g}",
                    "value": gap}
        return None

    def _check_nan(self, rule, rec) -> Optional[dict]:
        if rec.get("stream") not in _NAN_STREAMS:
            return None
        for k, v in rec.items():
            if k in ("stream", "run", "t_wall"):
                continue
            vals = v if isinstance(v, list) else [v]
            for item in vals:
                if _num(item) and not math.isfinite(item):
                    return {"message": f"non-finite {k} = {item!r}",
                            "value": item}
        return None

    def _check_norm(self, rule, rec) -> Optional[dict]:
        bound = rule.param("max")
        for field in ("update_norm", "grad_norm_max"):
            v = rec.get(field)
            if _num(v) and math.isfinite(v) and v > bound:
                return {"message": f"{field} {v:.4g} > {bound:g} "
                                   f"(exploding update)",
                        "value": v}
        return None

    def _check_stale(self, rule, rec) -> Optional[dict]:
        bound = rule.param("bound")
        v = rec.get("staleness")
        vals = v if isinstance(v, list) else [v]
        worst = max((x for x in vals if _num(x) and math.isfinite(x)),
                    default=None)
        if worst is not None and worst > bound:
            return {"message": f"staleness {worst:.4g} > declared bound "
                               f"{bound:g}",
                    "value": worst}
        return None

    def _check_restart(self, rule, rec) -> Optional[dict]:
        if rec.get("stream") != "fleet":
            return None
        v = rec.get("restarts")
        bound = rule.param("max")
        if _num(v) and v > bound:
            return {"message": f"fleet restarts {v:g} > {bound:g} "
                               f"(worker churn)",
                    "value": v}
        return None

    def _check_throughput(self, rule, rec) -> Optional[dict]:
        v = _events_value(rec)
        if v is None:
            return None
        window = int(rule.param("window", 20))
        if len(self._events) < window:
            return None
        trailing = list(self._events)[-window:]
        mean = sum(trailing) / len(trailing)
        frac = rule.param("frac")
        if mean > 0 and v < frac * mean:
            return {"message": f"events {v:.4g} < {frac:g} * trailing-"
                               f"{window} mean {mean:.4g} "
                               f"(throughput drop)",
                    "value": v}
        return None

    # -- record feed ----------------------------------------------------

    def feed(self, rec: dict) -> List[dict]:
        """Evaluate every rule against one record; returns (and retains)
        the alerts it fired."""
        self.records_seen += 1
        fired = []
        checks = {"eps": self._check_eps, "gap": self._check_gap,
                  "nan": self._check_nan, "norm": self._check_norm,
                  "stale": self._check_stale,
                  "throughput": self._check_throughput,
                  "restart": self._check_restart}
        for rule in self.rules:
            hit = checks[rule.kind](rule, rec)
            if hit is not None:
                schema_index = {"round": "round",
                                "fleet": "tick"}.get(rec.get("stream"),
                                                     "step")
                fired.append({"rule": rule.to_spec(),
                              "stream": rec.get("stream"),
                              "index": rec.get(schema_index),
                              **hit})
        ev = _events_value(rec)      # trailing window fed once per record
        if ev is not None:
            self._events.append(float(ev))
        self.alerts.extend(fired)
        return fired


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _events_value(rec: dict) -> Optional[float]:
    """The throughput proxy of one ``step`` record: events folded this
    tick (series records sum across servers)."""
    if rec.get("stream") != "step":
        return None
    v = rec.get("events")
    if isinstance(v, list):
        v = sum(x for x in v if _num(x))
    return float(v) if _num(v) else None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _iter_jsonl_lines(path: Path, *, follow: bool, interval: float,
                      max_seconds: Optional[float]):
    """Yield parsed records; in follow mode, poll for appended lines."""
    t0 = time.monotonic()
    with open(path, encoding="utf-8") as fh:
        while True:
            line = fh.readline()
            if line:
                line = line.strip()
                if line:
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        print(f"watch: skipping malformed line: "
                              f"{line[:80]}", file=sys.stderr)
                continue
            if not follow:
                return
            if (max_seconds is not None
                    and time.monotonic() - t0 > max_seconds):
                return
            time.sleep(interval)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.watch",
        description="Tail a telemetry JSONL and evaluate alert rules.")
    ap.add_argument("jsonl", type=Path, help="run JSONL (JsonlSink output)")
    ap.add_argument("--rules", default="nan",
                    help="watch rule spec (default: nan); see "
                         "the module docstring for the grammar")
    ap.add_argument("--epsilon-target", type=float, default=None,
                    help="epsilon_target for eps: rules without target=")
    ap.add_argument("--alerts", type=Path, default=None,
                    help="also append alerts to this JSONL file")
    ap.add_argument("--once", action="store_true",
                    help="read the whole file once; exit 1 iff any "
                         "alert fired (CI gate mode)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="poll interval in follow mode (seconds)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="stop following after this many seconds")
    args = ap.parse_args(argv)

    try:
        rules = parse_watch_spec(args.rules)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not args.jsonl.exists():
        print(f"error: {args.jsonl} does not exist", file=sys.stderr)
        return 2

    watcher = Watcher(rules, epsilon_target=args.epsilon_target)
    alerts_fh = None
    if args.alerts is not None:
        args.alerts.parent.mkdir(parents=True, exist_ok=True)
        alerts_fh = open(args.alerts, "a", encoding="utf-8")
    try:
        for rec in _iter_jsonl_lines(args.jsonl, follow=not args.once,
                                     interval=args.interval,
                                     max_seconds=args.max_seconds):
            for alert in watcher.feed(rec):
                line = (f"ALERT [{alert['rule']}] {alert['stream']}"
                        f"@{alert['index']}: {alert['message']}")
                print(line, file=sys.stderr)
                if alerts_fh is not None:
                    alerts_fh.write(json.dumps(alert) + "\n")
                    alerts_fh.flush()
    except KeyboardInterrupt:
        pass
    finally:
        if alerts_fh is not None:
            alerts_fh.close()

    n = len(watcher.alerts)
    print(f"{args.jsonl}: {watcher.records_seen} records, {n} alert(s) "
          f"[{watch_to_spec(rules)}]")
    return 1 if (args.once and n) else 0


if __name__ == "__main__":
    raise SystemExit(main())
