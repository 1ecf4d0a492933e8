"""Run inspector CLI: summarize a telemetry JSONL stream (a copy of
``repro.telemetry.inspect``).

    python -m repro_torch.telemetry.inspect RUN.jsonl
    python -m repro_torch.telemetry.inspect RUN.jsonl --stream round --tail 5
    python -m repro_torch.telemetry.inspect RUN.jsonl --trace RUN.trace.json
    python -m repro_torch.telemetry.inspect bench [BENCH_history.jsonl]

Reads the canonical JSONL sink output, re-validates every record against
the schema registry, and prints per-metric summaries (count / min / p50 /
p99 / max via the mergeable
:class:`~repro_torch.telemetry.sketch.QuantileSketch`),
the eps-vs-round table from the ``privacy`` stream, and a spectral-gap
sparkline from the ``round`` stream.  Exit code 0 when every record
parses and validates, 1 otherwise — CI uses that as the artifact
sanity gate.

The ``bench`` subcommand renders per-metric trend tables + sparklines
from the append-only ``BENCH_history.jsonl`` that
``benchmarks/meta.write_bench`` maintains (see ``benchmarks/compare.py``
for the gating half).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.telemetry.schema import SchemaError, validate_record
from repro_torch.telemetry.sketch import QuantileSketch

_ENVELOPE = ("stream", "run", "t_wall")
_SPARK = "▁▂▃▄▅▆▇█"


def load_records(path: Path, *, strict: bool = True
                 ) -> Tuple[List[dict], List[str]]:
    """Parse + schema-validate a JSONL file.  Returns (records, errors);
    with ``strict`` every malformed line is an error, otherwise it is
    skipped silently."""
    records: List[dict] = []
    errors: List[str] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{lineno}: bad JSON ({e.msg})")
                continue
            stream = rec.get("stream")
            body = {k: v for k, v in rec.items() if k not in _ENVELOPE}
            try:
                if stream is None:
                    raise SchemaError("record has no 'stream' field")
                validate_record(stream, body)
            except SchemaError as e:
                errors.append(f"{path}:{lineno}: {e}")
                continue
            records.append(rec)
    if not strict:
        errors = []
    return records, errors


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def metric_sketches(records: List[dict]) -> Dict[Tuple[str, str],
                                                 QuantileSketch]:
    """One sketch per (stream, numeric field); series fields contribute
    every element."""
    sketches: Dict[Tuple[str, str], QuantileSketch] = defaultdict(
        QuantileSketch)
    for rec in records:
        stream = rec.get("stream", "?")
        for k, v in rec.items():
            if k in _ENVELOPE:
                continue
            if _is_number(v) and math.isfinite(v):
                sketches[(stream, k)].add(v)
            elif isinstance(v, list):
                for item in v:
                    if _is_number(item) and math.isfinite(item):
                        sketches[(stream, k)].add(item)
    return dict(sketches)


def _fmt(v: float) -> str:
    return f"{v:.6g}"


def summary_table(records: List[dict]) -> str:
    sketches = metric_sketches(records)
    lines = [f"{'stream':<9} {'metric':<18} {'count':>7} {'min':>11} "
             f"{'p50':>11} {'p99':>11} {'max':>11}"]
    lines.append("-" * len(lines[0]))
    for (stream, field), sk in sorted(sketches.items()):
        p50, p99 = sk.quantiles([0.5, 0.99])
        lines.append(f"{stream:<9} {field:<18} {sk.count:>7} "
                     f"{_fmt(sk.min):>11} {_fmt(p50):>11} "
                     f"{_fmt(p99):>11} {_fmt(sk.max):>11}")
    return "\n".join(lines)


def eps_table(records: List[dict], *, max_rows: int = 12) -> Optional[str]:
    rows = [r for r in records if r.get("stream") == "privacy"]
    if not rows:
        return None
    lines = [f"{'step':>6} {'server':<9} {'eps':>11} {'delta':>11} "
             f"{'q':>8}"]
    lines.append("-" * len(lines[0]))
    shown = rows if len(rows) <= max_rows else (
        rows[: max_rows // 2] + [None] + rows[-max_rows // 2:])
    for r in shown:
        if r is None:
            lines.append(f"{'...':>6}")
            continue
        lines.append(
            f"{r.get('step', ''):>6} {str(r.get('server', '')):<9} "
            f"{_fmt(float(r.get('eps', float('nan')))):>11} "
            f"{_fmt(float(r.get('delta', float('nan')))):>11} "
            f"{_fmt(float(r.get('q', float('nan')))):>8}")
    return "\n".join(lines)


def sparkline(values: List[float], width: int = 60) -> str:
    vals = [v for v in values if _is_number(v) and math.isfinite(v)]
    if not vals:
        return "(no data)"
    if len(vals) > width:        # bucket-mean downsample to terminal width
        step = len(vals) / width
        vals = [sum(vals[int(i * step):max(int(i * step) + 1,
                                           int((i + 1) * step))])
                / max(1, int((i + 1) * step) - int(i * step))
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int((v - lo) / span * (len(_SPARK) - 1)))]
                   for v in vals)


def tail_lines(records: List[dict], stream: Optional[str],
               n: int) -> List[str]:
    rows = [r for r in records
            if stream is None or r.get("stream") == stream]
    return [json.dumps({k: v for k, v in r.items() if k != "run"})
            for r in rows[-n:]]


def check_trace(path: Path) -> List[str]:
    """Validate a Chrome trace-event JSON file; returns error strings."""
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable trace JSON ({e})"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [f"{path}: no traceEvents list"]
    errs = []
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts"):
            if key not in ev:
                errs.append(f"{path}: event {i} missing {key!r}")
                break
    return errs


# ---------------------------------------------------------------------------
# `inspect bench`: per-metric trends from BENCH_history.jsonl
# ---------------------------------------------------------------------------


def load_history(path: Path) -> List[dict]:
    entries: List[dict] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return entries


# not a dispatched kernel op: `backend` here is a history-entry filter,
# not a backend= dispatch switch  # gflint: disable=GFL004
def bench_trends(entries: List[dict], *, benchmark: Optional[str] = None,
                 backend: Optional[str] = None, last: int = 30
                 ) -> Dict[Tuple[str, str], dict]:
    """(benchmark, metric) -> trend dict with the value series (history
    order), direction, and the identifying shas/backends."""
    trends: Dict[Tuple[str, str], dict] = {}
    for e in entries:
        name = e.get("benchmark", "?")
        if benchmark and name != benchmark:
            continue
        if backend and e.get("backend") != backend:
            continue
        for metric, decl in (e.get("headline") or {}).items():
            v = decl.get("value")
            if not _is_number(v):
                continue
            t = trends.setdefault((name, metric), {
                "values": [], "shas": [],
                "direction": decl.get("direction", "?"),
                "backend": e.get("backend")})
            t["values"].append(float(v))
            t["shas"].append((e.get("git_sha") or "unknown")[:9])
    for t in trends.values():
        t["values"] = t["values"][-last:]
        t["shas"] = t["shas"][-last:]
    return trends


def bench_table(trends: Dict[Tuple[str, str], dict]) -> str:
    lines = [f"{'benchmark':<22} {'metric':<26} {'dir':<6} {'n':>3} "
             f"{'first':>11} {'last':>11} {'delta%':>8}  trend"]
    lines.append("-" * len(lines[0]))
    for (name, metric), t in sorted(trends.items()):
        vals = t["values"]
        first, lastv = vals[0], vals[-1]
        delta = ("-" if first == 0 or not math.isfinite(first)
                 else f"{100.0 * (lastv - first) / abs(first):+.1f}")
        lines.append(
            f"{name:<22} {metric:<26} {t['direction']:<6} {len(vals):>3} "
            f"{_fmt(first):>11} {_fmt(lastv):>11} {delta:>8}  "
            f"{sparkline(vals, width=24)}")
    return "\n".join(lines)


def bench_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.inspect bench",
        description="Render per-metric benchmark trends from "
                    "BENCH_history.jsonl.")
    ap.add_argument("history", type=Path, nargs="?",
                    default=Path("BENCH_history.jsonl"),
                    help="history JSONL (benchmarks/meta.write_bench "
                         "appends it)")
    ap.add_argument("--benchmark", default=None,
                    help="restrict to one benchmark")
    ap.add_argument("--backend", default=None,
                    help="restrict to one backend (cpu/tpu/gpu)")
    ap.add_argument("--last", type=int, default=30, metavar="N",
                    help="plot the last N history points (default 30)")
    args = ap.parse_args(argv)

    if not args.history.exists():
        print(f"error: {args.history} does not exist", file=sys.stderr)
        return 1
    entries = load_history(args.history)
    trends = bench_trends(entries, benchmark=args.benchmark,
                          backend=args.backend, last=args.last)
    print(f"{args.history}: {len(entries)} history entries, "
          f"{len(trends)} metric trend(s)")
    if trends:
        print()
        print(bench_table(trends))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        return bench_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.inspect",
        description="Summarize a telemetry run's JSONL record stream.")
    ap.add_argument("jsonl", type=Path, help="run JSONL (JsonlSink output)")
    ap.add_argument("--stream", default=None,
                    help="restrict the summary to one stream")
    ap.add_argument("--tail", type=int, default=0, metavar="N",
                    help="also print the last N raw records")
    ap.add_argument("--trace", type=Path, default=None,
                    help="validate a Chrome trace JSON alongside")
    args = ap.parse_args(argv)

    if not args.jsonl.exists():
        print(f"error: {args.jsonl} does not exist", file=sys.stderr)
        return 1
    records, errors = load_records(args.jsonl)
    if args.stream:
        records = [r for r in records if r.get("stream") == args.stream]

    by_stream: Dict[str, int] = defaultdict(int)
    for r in records:
        by_stream[r.get("stream", "?")] += 1
    counts = ", ".join(f"{s}={n}" for s, n in sorted(by_stream.items()))
    print(f"{args.jsonl}: {len(records)} records ({counts or 'none'})")

    if records:
        print()
        print(summary_table(records))
        eps = eps_table(records)
        if eps:
            print()
            print("privacy ledger (eps vs step):")
            print(eps)
        gaps = [r["gap"] for r in records
                if r.get("stream") == "round" and "gap" in r]
        if gaps:
            print()
            print(f"spectral gap  [{_fmt(min(gaps))}, {_fmt(max(gaps))}]:")
            print("  " + sparkline(gaps))
    if args.tail:
        print()
        print(f"last {args.tail} records:")
        for line in tail_lines(records, args.stream, args.tail):
            print("  " + line)

    if args.trace is not None:
        errors.extend(check_trace(args.trace))
        if not errors:
            n_ev = len(json.loads(args.trace.read_text())["traceEvents"])
            print(f"\n{args.trace}: valid Chrome trace ({n_ev} events)")

    if errors:
        print(f"\n{len(errors)} error(s):", file=sys.stderr)
        for e in errors:
            print("  " + e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
