"""Which functions of the port run inside a CUDA graph: the scope of GFL003
and GFL006.

The roots:

* the ``body`` methods of :class:`StagedStep` and of every class derived
  from it (by base name, across the scanned modules): the round bodies
  that ``core/population/graphed.py`` captures;
* every function called inside a ``with torch.cuda.graph(...)`` block, in
  the sources or in the test corpus (the card tests capture decode steps
  and kernel wrappers), and every function passed to
  ``torch.cuda.make_graphed_callables``.  A block that calls a parameter
  of its function (``_capture(fn, ...)``) follows the parameter to the
  arguments of that function's call sites, and a lambda to the calls it
  makes, so ``run_rounds``' closure is a root.  Blocks inside
  ``pytest.raises`` are left out: they are meant to fail.

Then the functions these call, followed only where the callee resolves to
exactly one definition: a nested or module-level definition, an imported
function or a module attribute (``ops.round_fold``) resolved through the
imports, a ``self.`` method through the class and its bases, or a method
of ``self.``'s attributes or of a parameter that may hold one of the
port's objects, by a name defined exactly once in the scanned sources (a
test's capture looks any receiver's method up so: ``model.decode_step``).
A builtin, a local's or a tensor's method (``x.max()``) and an ambiguous
name (``server_combine``, defined by every mechanism) are not followed:
here over-connecting would invent findings.  Nor is a kernel's launch
site followed into its ``*_plain`` / ``*_ref`` twin, which runs only off
the card (GFL004).
"""
from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (AnalysisContext, ModuleInfo,
                                            call_tail, dotted_name)
from repro_torch.analysis.rules._torch import (is_build_function, nodes,
                                               own_nodes, torch_names)

STEP_BASE = "StagedStep"
BODY = "body"
# how far a parameter called in a capture block is followed to call sites
BIND_DEPTH = 4
# a launch site's plain twin, which runs only off the card (GFL004)
OFF_CARD_SUFFIXES = ("_plain", "_ref")     # GFL004's counterparts
# text that a module holding a capture must contain
CAPTURE_HINTS = ("graph(", "make_graphed_callables")

Def = Tuple[ModuleInfo, ast.AST]            # (module, FunctionDef)


def module_name(path: str) -> str:
    """Dotted module name of a scanned file: ``src/repro_torch/x/y.py`` ->
    ``repro_torch.x.y`` (``__init__`` names its package)."""
    parts = path[:-3].split("/") if path.endswith(".py") else path.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _ModuleIndex:
    """One module's definitions, enclosing scopes and imports."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.name = module_name(mod.path)
        self.is_package = mod.path.endswith("__init__.py")
        self.top_defs: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.parent: Dict[int, Optional[ast.AST]] = {}  # def/class -> owner
        self.nested: Dict[int, Dict[str, ast.AST]] = defaultdict(dict)
        self.imports: Dict[str, str] = {}     # local name -> dotted target
        self.functions: List[ast.AST] = []
        self.owner: Dict[int, ast.AST] = {}   # node -> innermost function
        self._walk(mod.tree, None)
        for node in nodes(mod):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        self.imports[head] = head
            elif isinstance(node, ast.ImportFrom):
                base = self._absolute(node.module, node.level)
                for a in node.names:
                    if a.name != "*":
                        self.imports[a.asname or a.name] = \
                            f"{base}.{a.name}" if base else a.name

    def _absolute(self, module: Optional[str], level: int) -> str:
        if not level:
            return module or ""
        parts = self.name.split(".")
        if not self.is_package:
            parts = parts[:-1]
        parts = parts[:len(parts) - (level - 1)] if level > 1 else parts
        return ".".join(p for p in parts + [module or ""] if p)

    def _walk(self, node: ast.AST, owner: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            fn = next((o for o in self.chain(owner)
                       if not isinstance(o, ast.ClassDef)), None)
            if fn is not None:
                self.owner[id(child)] = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.parent[id(child)] = owner
                self.functions.append(child)
                if owner is None:
                    self.top_defs[child.name] = child
                else:
                    self.nested[id(owner)][child.name] = child
                self._walk(child, child)
            elif isinstance(child, ast.ClassDef):
                self.parent[id(child)] = owner
                if owner is None:
                    self.classes[child.name] = child
                self._walk(child, child)
            else:
                self._walk(child, owner)

    def chain(self, fn: Optional[ast.AST]) -> Iterable[ast.AST]:
        """``fn`` and the functions and classes enclosing it, innermost
        first."""
        while fn is not None:
            yield fn
            fn = self.parent.get(id(fn))


class Resolver:
    """Resolves callee expressions to definitions across the scanned
    sources; test modules resolve against the sources too."""

    def __init__(self, ctx: AnalysisContext):
        self.ctx = ctx
        self.index: Dict[str, _ModuleIndex] = {}     # path -> index
        self.by_name: Dict[str, _ModuleIndex] = {}   # dotted -> index
        self.defs_named: Dict[str, List[Def]] = defaultdict(list)
        for mod in ctx.source_modules():
            idx = _ModuleIndex(mod)
            self.index[mod.path] = idx
            self.by_name[idx.name] = idx
            for fn in idx.functions:
                self.defs_named[fn.name].append((mod, fn))
        self.by_path = {m.path for m in ctx.source_modules()}

    def module(self, mod: ModuleInfo) -> _ModuleIndex:
        idx = self.index.get(mod.path)
        if idx is None:                 # a test module, indexed on demand
            idx = self.index[mod.path] = _ModuleIndex(mod)
        return idx

    # -- definitions by qualified name ---------------------------------
    def qualified(self, dotted: str, depth: int = 0) -> Optional[Def]:
        """The function a dotted name ``pkg.mod.f`` (or a re-export of it)
        names, if any."""
        if depth > 4 or "." not in dotted:
            return None
        modname, _, attr = dotted.rpartition(".")
        idx = self.by_name.get(modname)
        if idx is None:
            return None
        if attr in idx.top_defs:
            return idx.mod, idx.top_defs[attr]
        target = idx.imports.get(attr)
        return self.qualified(target, depth + 1) if target else None

    def _class(self, idx: _ModuleIndex, name: str
               ) -> Optional[Tuple[_ModuleIndex, ast.ClassDef]]:
        if name in idx.classes:
            return idx, idx.classes[name]
        target = idx.imports.get(name)
        if target and "." in target:
            modname, _, attr = target.rpartition(".")
            other = self.by_name.get(modname)
            if other is not None and attr in other.classes:
                return other, other.classes[attr]
        return None

    def method(self, idx: _ModuleIndex, cls: ast.ClassDef, name: str,
               depth: int = 0) -> Optional[Def]:
        """``name`` looked up on ``cls`` and then its bases."""
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return idx.mod, node
        if depth > 8:
            return None
        for base in cls.bases:
            dotted = dotted_name(base)
            if dotted is None:
                continue
            head, _, attr = dotted.rpartition(".")
            found = None
            if not head:
                found = self._class(idx, attr)
            else:
                target = idx.imports.get(head.split(".")[0])
                other = self.by_name.get(
                    target + head[len(head.split(".")[0]):]
                    if target else "")
                if other is not None and attr in other.classes:
                    found = other, other.classes[attr]
            if found is not None:
                hit = self.method(found[0], found[1], name, depth + 1)
                if hit is not None:
                    return hit
        return None

    def unique(self, name: str) -> Optional[Def]:
        defs = self.defs_named.get(name, [])
        return defs[0] if len(defs) == 1 else None

    # -- a callee in context --------------------------------------------
    def callee(self, mod: ModuleInfo, scope: Optional[ast.AST],
               func: ast.AST, loose: bool = False) -> Optional[Def]:
        """The one definition the callee expression ``func`` (inside
        ``scope``, a function of ``mod`` or None) names, or None.  A method
        is looked up by name alone when its receiver is ``self.``-rooted or
        a parameter that may hold one of the port's objects, or anything
        with ``loose`` (a test's capture: ``model.decode_step``)."""
        idx = self.module(mod)
        if isinstance(func, ast.Name):
            name = func.id
            for owner in idx.chain(scope):
                if isinstance(owner, ast.ClassDef):
                    continue
                hit = idx.nested.get(id(owner), {}).get(name)
                if hit is not None:
                    return mod, hit
                if _is_param(owner, name):
                    return None
            if name in idx.top_defs:
                return mod, idx.top_defs[name]
            target = idx.imports.get(name)
            if target is not None:
                return self.qualified(target)
            return None                 # a builtin
        if isinstance(func, ast.Attribute):
            recv = dotted_name(func.value)
            if recv is None:
                return None             # a method of a call's result
            head = recv.split(".")[0]
            if recv == "self":
                cls = next((o for o in idx.chain(scope)
                            if isinstance(o, ast.ClassDef)), None)
                if cls is not None:
                    hit = self.method(idx, cls, func.attr)
                    if hit is not None:
                        return hit
            target = idx.imports.get(head)
            if target is not None:
                modname = target + recv[len(head):]
                if modname in self.by_name:
                    return self.qualified(f"{modname}.{func.attr}")
                return None             # an attribute of another package
            if loose or head == "self" or _port_param(scope, head):
                return self.unique(func.attr)
        return None

    def enclosing(self, mod: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
        """The innermost function of ``mod`` that holds ``node``."""
        return self.module(mod).owner.get(id(node))


def _is_param(fn: ast.AST, name: str) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
        return False
    a = fn.args
    every = a.posonlyargs + a.args + a.kwonlyargs
    extra = [x for x in (a.vararg, a.kwarg) if x is not None]
    return any(p.arg == name for p in every + extra)


# annotations of parameters that never hold one of the port's objects
FOREIGN_TYPES = ("Tensor", "str", "int", "float", "bool", "bytes", "Path",
                 "list", "dict", "tuple", "ndarray", "device", "dtype")


def _port_param(fn: Optional[ast.AST], name: str) -> bool:
    """A parameter of ``fn`` that may hold one of the port's objects: its
    methods are followed by name.  A local, a tensor or a string is not."""
    if fn is None or not _is_param(fn, name):
        return False
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.arg == name and p.annotation is not None:
            text = ast.unparse(p.annotation)
            return not any(t in text for t in FOREIGN_TYPES)
    return True


def _param_slot(fn: ast.AST, name: str) -> Tuple[Optional[int], str]:
    a = fn.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    pos = positional.index(name) if name in positional else None
    if pos is not None and positional and positional[0] in ("self", "cls"):
        pos -= 1                        # a bound method's call sites
    return pos, name


def graph_scope(ctx: AnalysisContext) -> "GraphScope":
    """The context's graph scope, computed once for GFL003 and GFL006."""
    scope = getattr(ctx, "_graph_scope", None)
    if scope is None:
        scope = ctx._graph_scope = GraphScope(ctx)
    return scope


class GraphScope:
    """The functions that run inside a CUDA graph, by definition node."""

    def __init__(self, ctx: AnalysisContext):
        self.resolver = Resolver(ctx)
        self.ctx = ctx
        self.members: Dict[int, Def] = {}
        roots = list(self._roots())
        frontier = list(roots)
        while frontier:
            mod, fn = frontier.pop()
            if id(fn) in self.members:
                continue
            self.members[id(fn)] = (mod, fn)
            calls = [n for n in own_nodes(fn) if isinstance(n, ast.Call)]
            launches = any(is_build_function(c) for c in calls)
            for node in calls:
                hit = self.resolver.callee(mod, fn, node.func)
                if hit is None or id(hit[1]) in self.members:
                    continue
                if launches and hit[1].name.endswith(OFF_CARD_SUFFIXES):
                    continue        # a launch site's off-card twin
                frontier.append(hit)

    def functions(self) -> List[Def]:
        return sorted(self.members.values(),
                      key=lambda d: (d[0].path, d[1].lineno))

    # -- roots -----------------------------------------------------------
    def _roots(self) -> Iterable[Def]:
        yield from self._step_bodies()
        for mod in list(self.ctx.source_modules()) + \
                list(self.ctx.test_modules):
            yield from self._captures(mod)

    def _step_bodies(self) -> Iterable[Def]:
        classes = [(mod, node) for mod in self.ctx.source_modules()
                   for node in nodes(mod)
                   if isinstance(node, ast.ClassDef)]
        family = {STEP_BASE}
        grew = True
        while grew:
            grew = False
            for _, cls in classes:
                if cls.name in family:
                    continue
                bases = {(dotted_name(b) or "").split(".")[-1]
                         for b in cls.bases}
                if bases & family:
                    family.add(cls.name)
                    grew = True
        for mod, cls in classes:
            if cls.name not in family:
                continue
            for node in cls.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == BODY:
                    yield mod, node

    def _captures(self, mod: ModuleInfo) -> Iterable[Def]:
        if not any(CAPTURE_HINTS[0] in ln or CAPTURE_HINTS[1] in ln
                   for ln in mod.lines):
            return
        names = torch_names(mod)
        expected_to_fail = _raises_blocks(mod)
        for node in nodes(mod):
            if isinstance(node, (ast.With, ast.AsyncWith)) \
                    and id(node) not in expected_to_fail \
                    and any(isinstance(it.context_expr, ast.Call)
                            and names.resolve(it.context_expr.func)
                            == "cuda.graph" for it in node.items):
                scope = self.resolver.enclosing(mod, node)
                for st in node.body:
                    for sub in [st, *own_nodes(st)]:
                        if isinstance(sub, ast.Call):
                            yield from self._callable(mod, scope, sub.func,
                                                      0)
            elif isinstance(node, ast.Call) and names.resolve(node.func) \
                    == "cuda.make_graphed_callables" and node.args:
                scope = self.resolver.enclosing(mod, node)
                first = node.args[0]
                items = first.elts if isinstance(first, (ast.Tuple,
                                                         ast.List)) \
                    else [first]
                for item in items:
                    yield from self._callable(mod, scope, item, 0)

    def _callable(self, mod: ModuleInfo, scope, expr: ast.AST,
                  depth: int) -> Iterable[Def]:
        """The definitions a callable expression passed to or called in a
        capture stands for."""
        if isinstance(expr, ast.Lambda):
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    yield from self._callable(mod, scope, sub.func, depth)
            return
        if isinstance(expr, ast.Name) and scope is not None \
                and _is_param(scope, expr.id) and depth < BIND_DEPTH:
            yield from self._bound(mod, scope, expr.id, depth + 1)
            return
        hit = self.resolver.callee(mod, scope, expr,
                                   loose=mod.path not in self.resolver.by_path)
        if hit is not None:
            yield hit

    def _bound(self, mod: ModuleInfo, fn: ast.AST, param: str,
               depth: int) -> Iterable[Def]:
        """What the call sites of ``fn`` pass as its parameter ``param``."""
        pos, name = _param_slot(fn, param)
        for caller in self.ctx.source_modules():
            for node in nodes(caller):
                if not isinstance(node, ast.Call) \
                        or call_tail(node) != fn.name:
                    continue
                scope = self.resolver.enclosing(caller, node)
                hit = self.resolver.callee(caller, scope, node.func)
                if hit is None or hit[1] is not fn:
                    continue
                arg = next((kw.value for kw in node.keywords
                            if kw.arg == name), None)
                if arg is None and pos is not None and pos < len(node.args):
                    arg = node.args[pos]
                if arg is not None:
                    yield from self._callable(caller, scope, arg, depth)


def _raises_blocks(mod: ModuleInfo) -> Set[int]:
    """Every ``with`` nested inside a ``with pytest.raises(...)``."""
    out: Set[int] = set()
    for node in nodes(mod):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and call_tail(it.context_expr) == "raises"
                for it in node.items):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.With, ast.AsyncWith)):
                    out.add(id(sub))
    return out
