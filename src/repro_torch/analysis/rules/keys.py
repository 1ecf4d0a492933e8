"""GFL001 — Generator hygiene.

The port keeps the reference's key discipline with explicit
:class:`torch.Generator` objects: one Generator a stream, reseeded for
each round from ``(seed, round, stream)`` (:mod:`repro_torch.draws`),
and every other draw takes a Generator made by the seed factory
(:func:`repro_torch.rng`).  Three sub-checks:

* **global generator**: a sampling call that draws from torch's global
  generator — ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``bernoulli`` / ``multinomial`` / ``normal`` / ``poisson``, or an
  in-place ``Tensor.uniform_`` / ``normal_`` / ``exponential_`` /
  ``random_`` / ``bernoulli_`` / ``cauchy_`` / ``log_normal_`` /
  ``geometric_`` — with no ``generator=`` argument.  Its bits depend on
  whatever else drew before it, so no run is reproducible and no two
  streams are known to be independent.
* **literal seeds**: ``torch.manual_seed(<int>)`` or
  ``<gen>.manual_seed(<int>)`` outside the seed factory
  (``repro_torch/__init__.py``) hard-codes the experiment seed at the call
  site, so sweeps silently share randomness.  A ``torch.Generator()``
  that draws before it is seeded is the same fault with torch's default
  seed as the literal.
* **reseed reuse**: ``manual_seed`` sets a Generator's Philox offset back
  to 0, so a Generator reseeded with the same seed expression it was
  already drawn from after draws the same bits again — two
  "independent" noise draws that are bit-identical.  This is the torch
  form of key reuse, found by the reference's abstract interpretation
  over statement lists: ``if``/``else`` branches fork the state and merge
  by union; loop bodies are scanned twice, with the loop target rebound
  before each pass; rebinding any name the seed expression reads (or the
  Generator itself) clears the mark.  Seed expressions that call a
  source of fresh values (``next``, ``time``, a random draw) never repeat.
  The same fault across streams: a loop over generators
  (``for stream, gen in gens.items()``) that reseeds each with a seed
  that reads nothing the loop varies gives every stream the same bits.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.framework import (AnalysisContext, Finding,
                                            ModuleInfo, Rule, call_tail,
                                            dotted_name)
from repro_torch.analysis.rules._torch import (TorchNames, has_splat, keyword,
                                               nodes, torch_names)

# torch functions that draw from a generator (the global one by default)
GLOBAL_SAMPLERS = frozenset({"rand", "randn", "randint", "randperm",
                             "bernoulli", "multinomial", "normal",
                             "poisson"})
# in-place Tensor samplers (any receiver, nn.init's included)
INPLACE_SAMPLERS = frozenset({"uniform_", "normal_", "exponential_",
                              "random_", "bernoulli_", "cauchy_",
                              "log_normal_", "geometric_"})
SEED_CALLS = frozenset({"manual_seed", "seed", "set_state",
                        "graphsafe_set_state"})
# passing a Generator here registers it; nothing is drawn
NON_DRAW_USES = frozenset({"register_generator_state"})
# seed expressions calling these give fresh values each time
FRESH_CALLS = frozenset({"next", "time", "time_ns", "perf_counter",
                         "monotonic", "urandom", "getrandbits", "random",
                         "randint", "integers", "initial_seed", "seed"})

# files allowed to seed with literals (the seed factory itself)
ALLOWED_LITERAL_SUFFIXES = ("repro_torch/__init__.py",)


def _is_int_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool))


def _free_names(expr: ast.AST) -> frozenset:
    return frozenset(n.id for n in ast.walk(expr) if isinstance(n, ast.Name))


def _fresh(expr: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and call_tail(n) in FRESH_CALLS
               for n in ast.walk(expr))


def _postorder(root: ast.AST) -> Iterable[ast.AST]:
    """Nodes of one statement in evaluation order (children first), not
    entering nested scopes: ``f(generator=g.manual_seed(s))`` reseeds
    before it draws."""
    for child in ast.iter_child_nodes(root):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        yield from _postorder(child)
    yield root


def _bound_names(node: ast.AST) -> Set[str]:
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign, ast.NamedExpr)):
        targets = [node.target]
    elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
        targets = [node.target]
    elif isinstance(node, ast.withitem) and node.optional_vars is not None:
        targets = [node.optional_vars]
    return {leaf.id for t in targets for leaf in ast.walk(t)
            if isinstance(leaf, ast.Name)}


class _State:
    """Per scope: each Generator name's current seed (key, free names,
    repeats a drawn seed) and the seeds drawn from since it was bound."""

    def __init__(self):
        self.current: Dict[str, Tuple[str, frozenset, bool]] = {}
        self.drawn: Dict[str, Dict[str, frozenset]] = {}

    def copy(self) -> "_State":
        out = _State()
        out.current = dict(self.current)
        out.drawn = {g: dict(d) for g, d in self.drawn.items()}
        return out

    def merge(self, other: "_State") -> "_State":
        out = _State()
        out.current = {g: s for g, s in self.current.items()
                       if other.current.get(g) == s}
        for src in (self, other):
            for g, d in src.drawn.items():
                out.drawn.setdefault(g, {}).update(d)
        return out

    def rebind(self, names: Set[str]) -> None:
        for g in list(self.current):
            if g in names or self.current[g][1] & names:
                del self.current[g]
        for g in list(self.drawn):
            if g in names:
                del self.drawn[g]
                continue
            self.drawn[g] = {k: free for k, free in self.drawn[g].items()
                             if not free & names}


class GeneratorHygieneRule(Rule):
    id = "GFL001"
    title = "Generator hygiene (global draws / literal seeds / reseeds)"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in ctx.source_modules():
            names = torch_names(mod)
            findings.extend(self._global_draws(mod, names))
            text = "\n".join(mod.lines)
            if "Generator" in text and \
                    not mod.path.endswith(ALLOWED_LITERAL_SUFFIXES):
                findings.extend(self._unseeded(mod, names))
            if "manual_seed" not in text:
                continue        # no seed: no literal seed, no reseed
            if not mod.path.endswith(ALLOWED_LITERAL_SUFFIXES):
                findings.extend(self._literal_seeds(mod))
            findings.extend(self._reseeds(mod))
            findings.extend(self._loop_seeds(mod))
        return findings

    # -- draws from the global generator -------------------------------
    def _global_draws(self, mod: ModuleInfo,
                      names: TorchNames) -> Iterable[Finding]:
        for node in nodes(mod):
            if not isinstance(node, ast.Call) or has_splat(node):
                continue
            if keyword(node, "generator") is not None:
                continue
            path = names.resolve(node.func)
            tail = call_tail(node)
            if path in GLOBAL_SAMPLERS:
                what = f"torch.{path}"
            elif tail in INPLACE_SAMPLERS:
                what = f"{dotted_name(node.func) or tail}"
            else:
                continue
            yield Finding(
                self.id, mod.path, node.lineno, node.col_offset,
                mod.context_of(node),
                f"{what}() draws from torch's global generator — pass "
                f"generator= (a draws stream or repro_torch.rng())")

    # -- manual_seed(<literal>) ----------------------------------------
    def _literal_seeds(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in nodes(mod):
            if not isinstance(node, ast.Call) \
                    or call_tail(node) != "manual_seed" or not node.args:
                continue
            seed = node.args[0]
            if _is_int_literal(seed):
                yield Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node),
                    f"literal seed {dotted_name(node.func) or 'manual_seed'}"
                    f"({ast.unparse(seed)}): hard-coded seed outside the "
                    f"seed factory; route through repro_torch.rng()")

    # -- torch.Generator() drawn from before it is seeded ----------------
    def _unseeded(self, mod: ModuleInfo,
                  names: TorchNames) -> Iterable[Finding]:
        def is_ctor(node) -> bool:
            return (isinstance(node, ast.Call)
                    and names.resolve(node.func) == "Generator")

        scopes = [mod.tree] + [n for n in nodes(mod)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        for scope in scopes:
            order = list(_postorder_scope(scope))
            gens = {t.id for node in order
                    if isinstance(node, ast.Assign) and is_ctor(node.value)
                    for t in node.targets if isinstance(t, ast.Name)}
            seeded: Set[str] = set()
            for node in order:
                if not isinstance(node, ast.Call):
                    continue
                recv = node.func.value if isinstance(node.func,
                                                     ast.Attribute) else None
                if isinstance(recv, ast.Name) and recv.id in gens \
                        and call_tail(node) in SEED_CALLS:
                    seeded.add(recv.id)
                    continue
                if call_tail(node) in NON_DRAW_USES:
                    continue
                args = list(node.args) + [kw.value for kw in node.keywords]
                for arg in args:
                    if is_ctor(arg):
                        yield self._unseeded_finding(mod, arg,
                                                     "torch.Generator()")
                    elif isinstance(arg, ast.Name) and arg.id in gens \
                            and arg.id not in seeded:
                        seeded.add(arg.id)      # report each once
                        yield self._unseeded_finding(mod, node, arg.id)

    def _unseeded_finding(self, mod, node, what) -> Finding:
        return Finding(
            self.id, mod.path, node.lineno, node.col_offset,
            mod.context_of(node),
            f"Generator {what} is drawn from before it is seeded — torch's "
            f"default seed is a literal seed; seed it or use "
            f"repro_torch.rng()")

    # -- a loop's generators reseeded alike -----------------------------
    def _loop_seeds(self, mod: ModuleInfo) -> Iterable[Finding]:
        for loop in nodes(mod):
            if not isinstance(loop, (ast.For, ast.AsyncFor)):
                continue
            gens = _bound_names(loop)
            varying = set(gens)
            for node in loop.body:
                for sub in _postorder(node):
                    varying |= _bound_names(sub)
            for node in loop.body:
                for call in _postorder(node):
                    if not (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "manual_seed"
                            and isinstance(call.func.value, ast.Name)
                            and call.func.value.id in gens and call.args):
                        continue
                    seed = call.args[0]
                    if _free_names(seed) & varying or _fresh(seed):
                        continue
                    yield Finding(
                        self.id, mod.path, call.lineno, call.col_offset,
                        mod.context_of(call),
                        f"the loop's generators '{call.func.value.id}' are "
                        f"each reseeded with the loop-invariant seed "
                        f"`{ast.unparse(seed)}` — every one draws the same "
                        f"bits; seed each from what the loop varies")

    # -- reseed reuse ---------------------------------------------------
    def _reseeds(self, mod: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        scopes = [mod.tree] + [n for n in nodes(mod)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        for scope in scopes:
            self._block(scope.body, _State(), mod, findings)
        # dedup per (line, col) — loop double-scan revisits statements
        return list({(f.line, f.col, f.message): f for f in findings}
                    .values())

    def _block(self, stmts, state: _State, mod: ModuleInfo,
               findings: List[Finding]) -> _State:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested scopes analyzed on their own
            if isinstance(st, ast.If):
                state = self._expr(st.test, state, mod, findings)
                a = self._block(st.body, state.copy(), mod, findings)
                b = self._block(st.orelse, state.copy(), mod, findings)
                state = a.merge(b)
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                if isinstance(st, ast.While):
                    state = self._expr(st.test, state, mod, findings)
                else:
                    state = self._expr(st.iter, state, mod, findings)
                for _ in range(2):
                    if not isinstance(st, ast.While):
                        state.rebind(_bound_names(st))
                    state = self._block(st.body, state, mod, findings)
                state = self._block(st.orelse, state, mod, findings)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    state = self._expr(item.context_expr, state, mod,
                                       findings)
                    state.rebind(_bound_names(item))
                state = self._block(st.body, state, mod, findings)
            elif isinstance(st, ast.Try):
                state = self._block(st.body, state, mod, findings)
                merged = state
                for h in st.handlers:
                    merged = merged.merge(self._block(
                        h.body, state.copy(), mod, findings))
                state = self._block(st.orelse, merged, mod, findings)
                state = self._block(st.finalbody, state, mod, findings)
            else:
                state = self._expr(st, state, mod, findings)
        return state

    def _expr(self, root, state: _State, mod: ModuleInfo,
              findings: List[Finding]) -> _State:
        for node in _postorder(root):
            if isinstance(node, ast.Call):
                self._call(node, state, mod, findings)
            bound = _bound_names(node)
            if bound and not isinstance(node, ast.comprehension):
                state.rebind(bound)
        return state

    def _call(self, node: ast.Call, state: _State, mod: ModuleInfo,
              findings: List[Finding]) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "manual_seed" \
                and isinstance(func.value, ast.Name) and node.args:
            g, seed = func.value.id, node.args[0]
            if _fresh(seed):
                state.current.pop(g, None)
                return
            key = ast.dump(seed)
            repeat = key in state.drawn.get(g, {})
            state.current[g] = (key, _free_names(seed), repeat)
            return
        gen = keyword(node, "generator")
        if isinstance(gen, ast.Call) and isinstance(gen.func, ast.Attribute) \
                and gen.func.attr == "manual_seed":
            gen = gen.func.value        # reseeded just above (post-order)
        if not isinstance(gen, ast.Name) or gen.id not in state.current:
            return
        g = gen.id
        key, free, repeat = state.current[g]
        if repeat:
            findings.append(Finding(
                self.id, mod.path, node.lineno, node.col_offset,
                mod.context_of(node),
                f"generator '{g}' reseeded with a seed it was already "
                f"drawn from, then drawn from again — manual_seed resets "
                f"the Philox offset, so this draw repeats the earlier one "
                f"bit for bit"))
        state.drawn.setdefault(g, {})[key] = free


def _postorder_scope(scope) -> Iterable[ast.AST]:
    """Every node of a scope in evaluation order, nested scopes left out."""
    for st in scope.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        yield from _postorder(st)
