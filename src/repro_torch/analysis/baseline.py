"""Baseline (grandfathered findings) support.

The baseline is a checked-in JSON inventory of known findings; CI fails
on any finding not in it ("new") and on any baseline entry that no
longer reproduces ("stale" — the debt was paid, so the entry must be
dropped to keep the inventory honest).  Entries match on
(rule, path, context, message) — line numbers are recorded for humans
but ignored for matching, so pure code motion never churns the file.
Each entry carries a free-form ``justification`` explaining why it is
grandfathered rather than fixed.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.framework import Finding

BASELINE_VERSION = 1
Key = Tuple[str, str, str, str]


def load_baseline(path) -> Dict[Key, dict]:
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    entries: Dict[Key, dict] = {}
    for e in data.get("findings", []):
        key = (e["rule"], e["path"], e.get("context", ""), e["message"])
        entries[key] = e
    return entries


def save_baseline(path, findings: Sequence[Finding],
                  old: Optional[Dict[Key, dict]] = None) -> None:
    """Write findings as the new baseline, carrying over justification
    strings from matching old entries."""
    old = old or {}
    out: List[dict] = []
    for f in sorted(findings):
        entry = f.to_dict()
        prev = old.get(f.key())
        entry["justification"] = (prev or {}).get(
            "justification", "TODO: justify or fix")
        out.append(entry)
    blob = json.dumps({"version": BASELINE_VERSION, "findings": out},
                      indent=2, sort_keys=True)
    Path(path).write_text(blob + "\n", encoding="utf-8")


def diff_against_baseline(findings: Sequence[Finding],
                          baseline: Dict[Key, dict]
                          ) -> Tuple[List[Finding], List[dict],
                                     List[Finding]]:
    """(new findings, stale baseline entries, matched findings)."""
    found_keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    matched = [f for f in findings if f.key() in baseline]
    stale = [e for k, e in sorted(baseline.items())
             if k not in found_keys]
    return new, stale, matched
