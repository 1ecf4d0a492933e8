"""GFL008 — process/network side channels route through core/fleet.

The fleet layer (:mod:`repro_torch.core.fleet`) owns every OS-level delivery
path in this repo: sockets live behind the :class:`Transport` ABC (with
its timeout / retry / idempotent-dedup contract) and worker processes
behind :class:`Fleet` (heartbeat tracking, elastic restart, write-ahead
checkpoints).  A raw ``socket`` or ``subprocess`` use anywhere else is
an unmanaged side channel: no retry budget, no dedup, invisible to the
``fleet`` telemetry stream, and unreachable by the chaos harness — the
failure modes the fleet layer exists to close.

The rule flags ``import socket`` / ``import subprocess`` (and their
``from ... import`` forms) in any source module outside ``core/fleet/``.
Flagging the import rather than individual calls keeps findings stable
under refactors and catches aliased use (``import subprocess as sp``).
Tooling that legitimately shells out (``kernels/_build.py`` running
``nvcc``) carries a line pragma ``# gflint: disable=GFL008`` with the
justification on the line.  The pass and its message are the
reference's, word for word.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.framework import AnalysisContext, Finding, Rule

RAW_NET_MODULES = frozenset({"socket", "subprocess"})


def _is_exempt_module(path: str) -> bool:
    # core/fleet IS the sanctioned home of sockets and process control
    parts = path.split("/")
    return "fleet" in parts


def _imported_raw(node: ast.AST):
    """Yield (module_name, node) for raw socket/subprocess imports."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            root = alias.name.split(".")[0]
            if root in RAW_NET_MODULES:
                yield root
    elif isinstance(node, ast.ImportFrom):
        root = (node.module or "").split(".")[0]
        if root in RAW_NET_MODULES:
            yield root


class NetRoutingRule(Rule):
    id = "GFL008"
    title = "raw socket/subprocess use must live in core/fleet"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in ctx.source_modules():
            if _is_exempt_module(mod.path):
                continue
            for node in ast.walk(mod.tree):
                for name in _imported_raw(node):
                    findings.append(Finding(
                        self.id, mod.path, node.lineno, node.col_offset,
                        mod.context_of(node),
                        f"raw '{name}' import outside core/fleet — "
                        f"delivery and process control must route through "
                        f"the fleet Transport/Fleet layer (timeout, retry, "
                        f"dedup, telemetry; docs/fleet.md)"))
        return findings
