"""GFL006 — no host side effect inside a CUDA-graph body.

A captured body runs its Python once, at capture; every replay runs only
the device work.  So a host side effect there fires once and never again
on replay, and ``telemetry.emit`` reads device values on the host (a sync)
and raises under capture (``telemetry/stream.py``).  Inside the graph
scope of GFL003 (:mod:`repro_torch.analysis.rules._graph`) the rule flags
``emit(...)``, ``print``, ``open``, ``logging.*`` and ``json.dump``.  The
in-graph routes are legal: ``MetricsStream.tap`` writes device values
into a device buffer the host drains after the run, and
``telemetry.stream.note`` records host values known at dispatch.  The
telemetry package is exempt (it IS the routing point), as is any module
whose path has a ``telemetry`` component.  This is the port's
counterpart of the reference's "route host callbacks through telemetry".
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.framework import (AnalysisContext, Finding, Rule,
                                            call_tail, dotted_name)
from repro_torch.analysis.rules._graph import graph_scope
from repro_torch.analysis.rules._torch import own_nodes

HOST_EFFECTS = frozenset({"print", "open"})


def _is_exempt_module(path: str) -> bool:
    return "telemetry" in path.split("/")


def _effect(call: ast.Call) -> Optional[str]:
    name = dotted_name(call.func)
    tail = call_tail(call)
    if tail == "emit":
        return "emit"
    if isinstance(call.func, ast.Name) and tail in HOST_EFFECTS:
        return tail
    if name is not None and (name.startswith("logging.")
                             or name == "json.dump"):
        return name
    return None


class GraphSideEffectRule(Rule):
    id = "GFL006"
    title = "no host side effect inside a CUDA-graph body"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        scope = graph_scope(ctx)
        sources = {m.path for m in ctx.source_modules()}
        findings: List[Finding] = []
        for mod, fn in scope.functions():
            if mod.path not in sources or _is_exempt_module(mod.path):
                continue
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = _effect(node)
                if what is None:
                    continue
                if what == "emit":
                    msg = ("telemetry emit() in CUDA-graph scope — it reads "
                           "device values on the host and raises under "
                           "capture; tap them into a MetricsStream")
                else:
                    msg = (f"host side effect {what}() in CUDA-graph scope "
                           f"— it runs once at capture and never on "
                           f"replay; tap device values into a MetricsStream "
                           f"or note host values (telemetry.stream.note)")
                findings.append(Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node), msg))
        return findings
