"""GFL004 — every CUDA launch has a plain twin and a parity test.

Each hand-written kernel of the port is reached through
``kernels/_build.py``: ``_build.function("<source>")`` builds
``csrc/<source>.cu`` on first use and returns its C entry point, and the
wrapper that calls that entry point is the kernel's one launch site.  The
``use_kernels`` switch and every CPU test are only trustworthy while each
launch site branches to a plain torch counterpart off the card (a
``*_plain`` or ``*_ref`` function: ``kernels/laplace.py`` is the pattern)
and a test of the port names both.  The rule takes its inventory from
the code:

* a **launch site** is a function that calls ``_build.function(...)`` and
  launches what it returns (calls it, or hands it to a launcher such as
  ``swa_decode.launch``).  A name listed in ``_build.AUX`` is a host-side
  query of a library, not a kernel; a function that only loads a library
  (the fleet's workers do, before they serve) launches nothing;
* each launch site must reference a ``*_plain`` / ``*_ref`` counterpart;
* some ``tests/test_torch_*.py`` must name the launch site and one of its
  counterparts;
* every source in ``_build.SOURCES`` must be named by some
  ``_build.function("<source>")``, and every name given to it must be a
  source or an ``AUX`` entry.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (AnalysisContext, Finding,
                                            ModuleInfo, Rule)
from repro_torch.analysis.rules._torch import (is_build_function, nodes,
                                               own_nodes)

BUILD_MODULE = "_build"
COUNTERPART_SUFFIXES = ("_plain", "_ref")


def _literal(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _inventory(ctx: AnalysisContext
               ) -> Tuple[Optional[ModuleInfo], Optional[ast.AST],
                          Tuple[str, ...], Set[str]]:
    """(``_build`` module, its SOURCES node, SOURCES, AUX names)."""
    for mod in ctx.source_modules():
        if not mod.path.endswith(f"/{BUILD_MODULE}.py") \
                and mod.path != f"{BUILD_MODULE}.py":
            continue
        sources: Tuple[str, ...] = ()
        node_at = None
        aux: Set[str] = set()
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                    or not isinstance(node.targets[0], ast.Name):
                continue
            name = node.targets[0].id
            if name == "SOURCES" and isinstance(node.value, (ast.Tuple,
                                                             ast.List)):
                sources = tuple(e.value for e in node.value.elts
                                if isinstance(e, ast.Constant))
                node_at = node
            elif name == "AUX" and isinstance(node.value, ast.Dict):
                aux = {k.value for k in node.value.keys
                       if isinstance(k, ast.Constant)}
        return mod, node_at, sources, aux
    return None, None, (), set()


def _launched(fn: ast.AST, call: ast.Call, parents: Dict[int, ast.AST]
              ) -> bool:
    """Whether the entry point ``call`` returns is launched in ``fn``."""
    parent = parents.get(id(call))
    if isinstance(parent, ast.Call):
        return True                 # called, or handed to a launcher
    if isinstance(parent, ast.keyword) and isinstance(
            parents.get(id(parent)), ast.Call):
        return True
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        var = parent.targets[0].id
        for node in own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == var:
                return True
            if any(isinstance(a, ast.Name) and a.id == var
                   for a in node.args):
                return True
    return False


def _references(mod: ModuleInfo) -> Tuple[Set[str], str]:
    """(identifiers, string literals joined) of a test module, kept on it:
    what ``AnalysisContext.test_references`` matches, collected once."""
    cached = getattr(mod, "_references", None)
    if cached is None:
        idents: Set[str] = set()
        texts: List[str] = []
        for node in nodes(mod):
            if isinstance(node, ast.Name):
                idents.add(node.id)
            elif isinstance(node, ast.Attribute):
                idents.add(node.attr)
            elif isinstance(node, ast.alias):
                idents.update(n for n in (node.name, node.asname) if n)
            elif isinstance(node, ast.arg):
                idents.add(node.arg)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                texts.append(node.value)
        cached = mod._references = (idents, "\0".join(texts))
    return cached


def _names(mod: ModuleInfo, name: str) -> bool:
    idents, texts = _references(mod)
    return name in idents or name in texts


def _counterparts(fn: ast.AST) -> List[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        name = node.id if isinstance(node, ast.Name) else \
            node.attr if isinstance(node, ast.Attribute) else None
        if name and name.endswith(COUNTERPART_SUFFIXES):
            out.add(name)
    return sorted(out)


class LaunchParityRule(Rule):
    id = "GFL004"
    title = "CUDA launch sites have a plain twin + parity test"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        build_mod, sources_node, sources, aux = _inventory(ctx)
        named: Set[str] = set()
        for mod in ctx.source_modules():
            if not any("function(" in ln for ln in mod.lines):
                continue
            parents = {id(c): p for p in nodes(mod)
                       for c in ast.iter_child_nodes(p)}
            for fn in nodes(mod):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                launches = False
                for node in own_nodes(fn):
                    if not is_build_function(node):
                        continue
                    kernel = _literal(node)
                    if kernel is not None:
                        named.add(kernel)
                        if build_mod is not None and kernel not in aux \
                                and kernel not in sources:
                            findings.append(Finding(
                                self.id, mod.path, node.lineno,
                                node.col_offset, mod.context_of(node),
                                f"_build.function('{kernel}') names no "
                                f"source in _build.SOURCES or AUX"))
                    if kernel in aux:
                        continue        # a host query, not a kernel
                    launches = launches or _launched(fn, node, parents)
                if launches:
                    findings.extend(self._site(ctx, mod, fn))
        if build_mod is not None and sources_node is not None:
            for src in sources:
                if src not in named:
                    findings.append(Finding(
                        self.id, build_mod.path, sources_node.lineno,
                        sources_node.col_offset, "",
                        f"kernel source '{src}' in _build.SOURCES is never "
                        f"launched through _build.function('{src}')"))
        return findings

    def _site(self, ctx: AnalysisContext, mod: ModuleInfo,
              fn: ast.AST) -> Iterable[Finding]:
        twins = _counterparts(fn)
        if not twins:
            yield Finding(
                self.id, mod.path, fn.lineno, fn.col_offset,
                mod.context_of(fn),
                f"CUDA launch site '{fn.name}' has no plain counterpart "
                f"(no *_plain / *_ref reference in its body) to run off "
                f"the card")
            return
        if not any(_names(t, fn.name) and any(_names(t, c) for c in twins)
                   for t in ctx.test_modules):
            yield Finding(
                self.id, mod.path, fn.lineno, fn.col_offset,
                mod.context_of(fn),
                f"CUDA launch site '{fn.name}' has no parity test naming it "
                f"and its counterpart ({', '.join(twins)})")
