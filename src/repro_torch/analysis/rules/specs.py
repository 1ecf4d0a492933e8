"""GFL005 — spec grammar round-trips.

Config surfaces in this repo are spec strings (``links:0.1+dropout:0.2``,
``uniform+trace:diurnal,...``, ``async:buffer=8,...``) with a
``parse_*_spec`` / ``*_to_spec`` pair each.  A parser whose inverse is
untested drifts silently — checkpoint metadata and sweep manifests stop
round-tripping.  The rule requires that

* every top-level ``parse_*_spec`` function is registered in the spec
  grammar registry (:mod:`repro_torch.core.specs`), so the inventory is
  enumerable instead of pattern-matched, and
* every registered grammar has round-trip test evidence: a test that
  drives the registry (``all_grammars`` / ``get_grammar``) covers all of
  them; otherwise a test must reference both the parse function and a
  ``to_spec``.

The pass is the reference's, and so are its messages, word for word
(they name the reference's registry module), so the two analyzers'
findings on the same sources compare equal.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.framework import (AnalysisContext, Finding, Rule,
                                      call_tail, dotted_name)

REGISTRY_ENTRY_NAMES = ("all_grammars", "get_grammar", "spec_grammars")


class SpecRoundTripRule(Rule):
    id = "GFL005"
    title = "every parse/to_spec grammar registered and inverse-tested"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []

        parsers: List[Tuple[str, object, object]] = []  # (name, mod, node)
        for mod in ctx.source_modules():
            for node in mod.tree.body:
                if isinstance(node, ast.FunctionDef) \
                        and node.name.startswith("parse_") \
                        and node.name.endswith("_spec"):
                    parsers.append((node.name, mod, node))

        # registered grammars: register_grammar("name", parse=..., ...)
        registered: Dict[str, Tuple[object, object]] = {}
        registered_parse_names: set = set()
        for mod in ctx.source_modules():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call) \
                        or call_tail(node) != "register_grammar":
                    continue
                gname = None
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    gname = node.args[0].value
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    ref = dotted_name(arg)
                    if ref:
                        registered_parse_names.add(ref.split(".")[-1])
                if gname is not None:
                    registered[gname] = (mod, node)

        for pname, mod, node in parsers:
            if pname not in registered_parse_names:
                findings.append(Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node),
                    f"spec parser '{pname}' is not registered in the "
                    f"spec-grammar registry (repro.core.specs) — its "
                    f"round-trip cannot be enumerated"))

        registry_driven = any(ctx.test_references(n)
                              for n in REGISTRY_ENTRY_NAMES)
        for gname, (mod, node) in sorted(registered.items()):
            if registry_driven:
                break
            parse_ref = None
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                ref = dotted_name(arg)
                if ref and ref.split(".")[-1].startswith("parse_"):
                    parse_ref = ref.split(".")[-1]
            evidenced = (parse_ref is not None
                         and ctx.test_references(parse_ref)
                         and ctx.test_references("to_spec"))
            if not evidenced:
                findings.append(Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node),
                    f"registered spec grammar '{gname}' has no "
                    f"round-trip test (drive all_grammars()/get_grammar "
                    f"or test its parse/to_spec pair directly)"))
        return findings
