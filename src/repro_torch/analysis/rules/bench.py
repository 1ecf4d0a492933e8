"""GFL007 — benchmark payload routing.

Repo-root ``BENCH_*.json`` payloads are the perf trajectory: they carry
the provenance ``meta`` block, declare headline metrics, and append the
compact record to ``BENCH_history.jsonl`` that ``benchmarks/compare.py``
gates on.  All of that happens inside :func:`benchmarks.meta.write_bench`
— a payload written with a raw ``json.dump`` / ``Path.write_text`` is an
unattributable, history-less file outside the regression gate.  The port
writes no ``BENCH_*.json`` today; the rule keeps it so until its
benchmark routes through the same point.

The rule flags any write-shaped call — ``write_text`` / ``write_bytes``
/ ``json.dump`` tails, or ``open(..., "w"/"a"/"x")`` — whose argument
subtree mentions a ``BENCH_*.json[l]`` literal or a name assigned from
one.  ``benchmarks/meta.py`` is exempt (it IS the routing point);
one-off exceptions carry ``# gflint: disable=GFL007`` with the
justification reviewed like any baseline entry.  The pass and its
message are the reference's, word for word.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, List, Set

from repro_torch.analysis.framework import (AnalysisContext, Finding, Rule,
                                      call_tail)

BENCH_FILE_RE = re.compile(r"\bBENCH_\w+\.jsonl?\b")
# callee tails that persist a payload to disk
WRITE_TAILS = frozenset({"write_text", "write_bytes", "dump"})
_WRITE_MODES = ("w", "a", "x")


def _is_exempt_module(path: str) -> bool:
    # the sanctioned call site and the stdlib-only gate that reads what it
    # wrote
    return path.endswith("benchmarks/meta.py") \
        or path.endswith("benchmarks/compare.py") \
        or path == "benchmarks/meta.py" or path == "benchmarks/compare.py"


def _mentions_bench_literal(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and BENCH_FILE_RE.search(sub.value)):
            return True
    return False


def _bench_names(tree: ast.Module) -> Set[str]:
    """Names assigned (anywhere in the module) from an expression that
    mentions a BENCH_*.json literal or an already-known bench name —
    e.g. ``OUT = REPO_ROOT / "BENCH_kernels.json"``; ``p = OUT``."""
    names: Set[str] = set()
    for _ in range(2):  # one extra pass resolves simple aliases
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if value is None:
                continue
            hit = _mentions_bench_literal(value) or any(
                isinstance(sub, ast.Name) and sub.id in names
                for sub in ast.walk(value))
            if not hit:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


def _open_write_mode(call: ast.Call) -> bool:
    """True for ``open(..., "w"|"a"|"x")`` (positional or mode= kw)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None or not (isinstance(mode, ast.Constant)
                            and isinstance(mode.value, str)):
        return False
    return any(m in mode.value for m in _WRITE_MODES)


def _targets_bench(call: ast.Call, bench_names: Set[str]) -> bool:
    for sub in ast.walk(call):
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and BENCH_FILE_RE.search(sub.value)):
            return True
        if isinstance(sub, ast.Name) and sub.id in bench_names:
            return True
    return False


class BenchWriteRoutingRule(Rule):
    id = "GFL007"
    title = "BENCH_*.json writes must route through benchmarks.meta" \
            ".write_bench"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in ctx.source_modules():
            if _is_exempt_module(mod.path):
                continue
            if not any("BENCH_" in ln for ln in mod.lines):
                continue        # every finding needs a BENCH_* literal
            bench_names = _bench_names(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                tail = call_tail(node)
                if tail in WRITE_TAILS:
                    pass
                elif tail == "open" and _open_write_mode(node):
                    pass
                else:
                    continue
                if not _targets_bench(node, bench_names):
                    continue
                findings.append(Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node),
                    f"raw {tail}() write of a BENCH_*.json payload — "
                    f"bypasses provenance, headline declaration and the "
                    f"BENCH_history.jsonl regression gate; route through "
                    f"benchmarks.meta.write_bench"))
        return findings
