"""AST helpers that the torch-aimed rules share: how a module names
torch, and which nodes belong to a function's own body."""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.framework import dotted_name


def nodes(mod) -> List[ast.AST]:
    """Every node of a module, walked once and kept on the module."""
    cached = getattr(mod, "_nodes", None)
    if cached is None:
        cached = mod._nodes = list(ast.walk(mod.tree))
    return cached


def torch_names(mod) -> "TorchNames":
    """The module's :class:`TorchNames`, built once and kept on it."""
    cached = getattr(mod, "_torch_names", None)
    if cached is None:
        cached = mod._torch_names = TorchNames(
            [n for n in nodes(mod)
             if isinstance(n, (ast.Import, ast.ImportFrom))])
    return cached


class TorchNames:
    """Map Name/Attribute chains back to paths inside ``torch`` through
    the module's imports: ``import torch`` (``torch.randn`` -> "randn"),
    ``import torch.nn.functional as F`` (``F.relu`` -> "nn.functional.relu"),
    ``from torch import randn as r`` (``r`` -> "randn")."""

    def __init__(self, imports):
        """``imports``: a module's tree, or its import statements."""
        if isinstance(imports, ast.AST):
            imports = ast.walk(imports)
        self.prefixes: Dict[str, str] = {}
        for node in imports:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name != "torch" and not a.name.startswith("torch."):
                        continue
                    if a.asname:
                        self.prefixes[a.asname] = a.name[len("torch."):] \
                            if a.name != "torch" else ""
                    else:
                        self.prefixes["torch"] = ""
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module is not None \
                    and (node.module == "torch"
                         or node.module.startswith("torch.")):
                base = node.module[len("torch"):].lstrip(".")
                for a in node.names:
                    self.prefixes[a.asname or a.name] = \
                        f"{base}.{a.name}" if base else a.name

    def resolve(self, node: ast.AST) -> Optional[str]:
        """The dotted path inside torch that ``node`` names ("" for the
        module itself), or None when it does not name torch."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        if head not in self.prefixes:
            return None
        base = self.prefixes[head]
        return ".".join(p for p in (base, rest) if p)


def own_nodes(owner: ast.AST) -> Iterable[ast.AST]:
    """Walk a function (or module) body without entering nested function
    or class definitions, which are their own units; lambdas stay with
    their enclosing function."""
    stack = list(ast.iter_child_nodes(owner))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def is_build_function(node: ast.AST) -> bool:
    """``_build.function(...)``: the call that hands a kernel's wrapper its
    C entry point (``kernels/_build.py``)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name is not None and (name == "_build.function"
                                 or name.endswith("._build.function"))


def keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def has_splat(call: ast.Call) -> bool:
    """True when ``**kwargs`` may carry any keyword."""
    return any(kw.arg is None for kw in call.keywords)
