"""gflint CLI for the port: ``python -m repro_torch.analysis [options]
[paths...]``.

With no paths it scans ``src/repro_torch`` and reads
``analysis/baseline_torch.json`` when that file exists.  Exit codes, as
the reference analyzer's: 0 clean (or fully baselined), 1 new findings or
stale baseline entries, 2 usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (diff_against_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.framework import run_analysis
from repro_torch.analysis.rules import ALL_RULES

DEFAULT_BASELINE = Path("analysis") / "baseline_torch.json"
DEFAULT_SOURCES = Path("src") / "repro_torch"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="gflint for the PyTorch/CUDA port: privacy/repro "
                    "invariant analysis (GFL001-GFL008)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to analyze (default: "
                         "src/repro_torch if present, else .)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="baseline JSON of grandfathered findings "
                         "(default: analysis/baseline_torch.json when it "
                         "exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline; report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(keeps existing justifications)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=".",
                    help="root that finding paths are relative to")
    ap.add_argument("--list-rules", action="store_true")
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id}  {cls.title}")
        return 0

    root = Path(args.root)
    paths = args.paths or None
    if not paths:
        default = root / DEFAULT_SOURCES
        paths = [default] if default.is_dir() else [root]

    findings = run_analysis(paths, root=root)

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline:
        candidate = root / DEFAULT_BASELINE
        if candidate.is_file():
            baseline_path = candidate
    baseline: dict = {}
    if baseline_path and not args.no_baseline:
        baseline_path = Path(baseline_path)
        if baseline_path.is_file():
            baseline = load_baseline(baseline_path)
        elif not args.write_baseline:
            print(f"gflint: baseline {baseline_path} not found",
                  file=sys.stderr)
            return 2

    if args.write_baseline:
        target = Path(baseline_path or root / DEFAULT_BASELINE)
        target.parent.mkdir(parents=True, exist_ok=True)
        save_baseline(target, findings, baseline)
        print(f"gflint: wrote {len(findings)} finding(s) to {target}")
        return 0

    new, stale, matched = diff_against_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "stale": stale,
            "baselined": len(matched),
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"stale baseline entry: {e['rule']} {e['path']} "
                  f"{e['message']!r} no longer reproduces — remove it "
                  f"(or run --write-baseline)")
        status = (f"gflint: {len(findings)} finding(s): {len(new)} new, "
                  f"{len(matched)} baselined, {len(stale)} stale")
        print(status)

    return 1 if (new or stale) else 0
