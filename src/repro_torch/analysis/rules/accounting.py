"""GFL002 — accountant coverage.

Every *release site* must be reachable from some caller chain that also
charges the accountant.  The port's release sites are the mechanism
protection hooks ``client_protect`` / ``client_protect_masked`` and the
noise trees ``client_noise_tree`` / ``combine_noise_tree``
(``core/privacy/mechanism.py``), the noise combiners
``homomorphic_combine_noise`` / ``iid_noise_combine``
(``core/privacy/homomorphic.py``), the secure-agg mask draws
``pairwise_masks_vec`` / ``masked_client_mean_dropout_vec``
(``core/privacy/secure_agg.py``) and the fused kernel fold
``ops.round_fold`` (``kernels/ops.py``).  The charges are
``PrivacyAccountant.advance`` and ``AsyncAccountant.record_round`` /
``record_schedule`` (``core/privacy/accountant.py``).  A release no
accountant ever hears about is the failure mode Theorem 2's budget
bookkeeping forbids.

The names are the reference's, so the pass is the reference's, and on
the same sources it reports the same findings, word for word.  It
builds a name-matched reference graph over the scanned modules: each
function definition is a node; any bare-name or attribute-tail reference
to a known definition name is an edge (this deliberately over-connects —
e.g. all ``client_protect`` methods merge — which only ever *suppresses*
findings, never invents them).  A function containing a release call is
flagged when no transitive referrer (including itself and module-level
code) contains a charge call.
"""
from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.framework import (AnalysisContext, Finding, Rule,
                                      call_tail)

RELEASE_NAMES = frozenset({
    "client_protect", "client_protect_masked",
    "homomorphic_combine_noise", "iid_noise_combine",
    "pairwise_masks_vec", "masked_client_mean_dropout_vec",
    "client_noise_tree", "combine_noise_tree",
    "round_fold",
})
CHARGE_NAMES = frozenset({"advance", "record_round", "record_schedule"})


class _FuncNode:
    __slots__ = ("name", "module", "context", "refs", "releases",
                 "has_charge", "line", "col")

    def __init__(self, name, module, context, line, col):
        self.name = name
        self.module = module
        self.context = context
        self.refs: Set[str] = set()
        self.releases: List[Tuple[int, int, str]] = []
        self.has_charge = False
        self.line = line
        self.col = col


def _collect_own_nodes(body_owner) -> Iterable[ast.AST]:
    """Walk a function/module body but stop at nested function/class
    definitions (they become their own graph nodes); lambdas stay with
    their enclosing function."""
    stack = list(ast.iter_child_nodes(body_owner))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class AccountantCoverageRule(Rule):
    id = "GFL002"
    title = "every release site reachable from an accountant charge"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        nodes: List[_FuncNode] = []
        for mod in ctx.source_modules():
            defs = [mod.tree] + [
                n for n in ast.walk(mod.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for d in defs:
                if isinstance(d, ast.Module):
                    node = _FuncNode("<module>", mod, "", 0, 0)
                else:
                    node = _FuncNode(d.name, mod, mod.context_of(d),
                                     d.lineno, d.col_offset)
                for child in _collect_own_nodes(d):
                    if isinstance(child, ast.Call):
                        tail = call_tail(child)
                        if tail in CHARGE_NAMES:
                            node.has_charge = True
                        if tail in RELEASE_NAMES:
                            node.releases.append(
                                (child.lineno, child.col_offset, tail))
                    if isinstance(child, ast.Name):
                        node.refs.add(child.id)
                    elif isinstance(child, ast.Attribute):
                        node.refs.add(child.attr)
                nodes.append(node)

        # reverse edges by definition name: who references name N?
        referrers: Dict[str, List[_FuncNode]] = defaultdict(list)
        def_names = {n.name for n in nodes if n.name != "<module>"}
        for n in nodes:
            for ref in n.refs & def_names:
                referrers[ref].append(n)

        findings: List[Finding] = []
        for n in nodes:
            if not n.releases:
                continue
            if self._reaches_charge(n, referrers):
                continue
            reported: set = set()
            for line, col, rel in n.releases:
                if rel in reported:
                    continue
                reported.add(rel)
                if n.name == "<module>":
                    where = ""
                else:
                    where = (n.context + "." + n.name if n.context
                             else n.name)
                findings.append(Finding(
                    self.id, n.module.path, line, col, where,
                    f"release site '{rel}' in {where or '<module>'} is "
                    f"not reachable "
                    f"from any accountant charge "
                    f"(advance/record_round/record_schedule)"))
        return findings

    @staticmethod
    def _reaches_charge(start: _FuncNode, referrers) -> bool:
        seen = {id(start)}
        frontier = [start]
        while frontier:
            node = frontier.pop()
            if node.has_charge:
                return True
            if node.name == "<module>":
                continue  # module-level code has no callers
            for parent in referrers.get(node.name, ()):
                if id(parent) not in seen:
                    seen.add(id(parent))
                    frontier.append(parent)
        return False
