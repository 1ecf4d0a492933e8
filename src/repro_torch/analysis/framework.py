"""gflint core for the port: modules, findings, rule protocol and the
analysis runner.

The same design as the reference analyzer's: one :class:`ModuleInfo` per
parsed source file; rules implement ``check(ctx)`` over an
:class:`AnalysisContext`, so cross-module invariants (graph-body
reachability, test evidence) are first-class.  Test files are parsed into
the context as an *evidence corpus* (GFL004/GFL005 look for parity and
round-trip tests there) but are never themselves linted.  The port's
corpus is its own tests, ``test_torch_*.py``: a test of the reference is
no evidence for a torch op.

Suppression is the reference's grammar, which both analyzers read: a
trailing or preceding ``# gflint: disable=GFL001`` comment silences a
rule on that line; ``# gflint: disable-file=GFL003`` near the top of a
file silences it for the whole module.  Grandfathered findings belong in
the checked-in baseline (``analysis/baseline_torch.json``, see
:mod:`repro_torch.analysis.baseline`) with a justification string.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(r"#\s*gflint:\s*disable=([A-Z0-9,\s]+)")
FILE_PRAGMA_RE = re.compile(r"#\s*gflint:\s*disable-file=([A-Z0-9,\s]+)")
PARSE_ERROR_RULE = "GFL000"
# how many leading lines may carry a disable-file pragma
_FILE_PRAGMA_WINDOW = 10
# the port's tests: the evidence corpus when the caller names no test paths
PORT_TEST_PREFIX = "test_torch_"


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation.

    The baseline matches findings on :meth:`key` — (rule, path, context,
    message) — NOT on line numbers, so moving code around does not churn
    the baseline; only adding/removing violations does.
    """
    rule: str
    path: str          # posix path relative to the analysis root
    line: int
    col: int
    context: str       # enclosing function qualname ("" = module level)
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.context, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "context": self.context,
                "message": self.message}

    def render(self) -> str:
        where = f" [in {self.context}]" if self.context else ""
        return (f"{self.path}:{self.line}:{self.col} {self.rule} "
                f"{self.message}{where}")


@dataclass
class ModuleInfo:
    """One parsed source file plus the derived lookup tables rules need."""
    path: str                      # posix relpath from the analysis root
    tree: ast.Module
    lines: List[str]
    is_test: bool = False
    file_disabled: frozenset = frozenset()
    # node -> qualname of the enclosing function chain, filled lazily
    _contexts: Optional[Dict[int, str]] = field(default=None, repr=False)

    def context_of(self, node: ast.AST) -> str:
        """Qualified name of the function enclosing `node` ("" = module)."""
        if self._contexts is None:
            self._contexts = _build_contexts(self.tree)
        return self._contexts.get(id(node), "")

    def line_disabled(self, line: int, rule: str) -> bool:
        """True when a pragma on the finding's line (or the line above)
        disables `rule`."""
        if rule in self.file_disabled:
            return True
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = PRAGMA_RE.search(self.lines[ln - 1])
                if m and rule in _split_rules(m.group(1)):
                    return True
        return False


def _split_rules(blob: str) -> frozenset:
    return frozenset(r.strip() for r in blob.split(",") if r.strip())


def _build_contexts(tree: ast.Module) -> Dict[int, str]:
    contexts: Dict[int, str] = {}

    def walk(node: ast.AST, stack: Tuple[str, ...]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                contexts[id(child)] = ".".join(stack) if stack else ""
                walk(child, stack + (child.name,))
            else:
                contexts[id(child)] = ".".join(stack)
                walk(child, stack)

    walk(tree, ())
    return contexts


def dotted_name(node: ast.AST) -> Optional[str]:
    """Flatten a Name/Attribute chain to "a.b.c" (None for anything else,
    e.g. a call result used as a callee)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_tail(call: ast.Call) -> Optional[str]:
    """Last component of the callee name: ``mech.client_protect(...)`` ->
    "client_protect"."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class Rule:
    """Base class: rules declare an id/title and implement ``check``."""

    id: str = "GFL???"
    title: str = ""

    def check(self, ctx: "AnalysisContext") -> Iterable[Finding]:
        raise NotImplementedError


class AnalysisContext:
    """Everything a rule may look at: lint targets + test evidence."""

    def __init__(self, modules: Sequence[ModuleInfo],
                 test_modules: Sequence[ModuleInfo], root: Path):
        self.modules = list(modules)
        self.test_modules = list(test_modules)
        self.root = root

    def source_modules(self) -> List[ModuleInfo]:
        """The lintable (non-test) modules."""
        return self.modules

    def test_references(self, name: str) -> bool:
        """True when any test module references `name` (as a bare name, an
        attribute tail, or inside a string literal — covers parametrized
        test ids)."""
        for mod in self.test_modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Name) and node.id == name:
                    return True
                if isinstance(node, ast.Attribute) and node.attr == name:
                    return True
                if isinstance(node, ast.alias) and name in (node.name,
                                                            node.asname):
                    return True
                if isinstance(node, ast.arg) and node.arg == name:
                    return True
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and name in node.value):
                    return True
        return False


def is_port_test(path: str) -> bool:
    """A test of the port: ``test_torch_*.py``."""
    return Path(path).name.startswith(PORT_TEST_PREFIX)


def _is_test_path(rel: Path) -> bool:
    return ("tests" in rel.parts or "test" in rel.parts
            or rel.name.startswith("test_") or rel.name == "conftest.py")


def load_module(path: Path, root: Path) -> ModuleInfo:
    rel = path.resolve().relative_to(root.resolve()) \
        if path.resolve().is_relative_to(root.resolve()) else path
    text = path.read_text(encoding="utf-8")
    lines = text.splitlines()
    disabled: frozenset = frozenset()
    for ln in lines[:_FILE_PRAGMA_WINDOW]:
        m = FILE_PRAGMA_RE.search(ln)
        if m:
            disabled = disabled | _split_rules(m.group(1))
    tree = ast.parse(text, filename=str(path))
    return ModuleInfo(path=rel.as_posix(), tree=tree, lines=lines,
                      is_test=_is_test_path(rel), file_disabled=disabled)


def collect_modules(paths: Sequence[Path], root: Path
                    ) -> Tuple[List[ModuleInfo], List[ModuleInfo],
                               List[Finding]]:
    """Parse every .py under `paths`; returns (source modules, test
    modules, parse-error findings)."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    seen: set = set()
    sources: List[ModuleInfo] = []
    tests: List[ModuleInfo] = []
    errors: List[Finding] = []
    for f in files:
        key = f.resolve()
        if key in seen:
            continue
        seen.add(key)
        try:
            mod = load_module(f, root)
        except SyntaxError as e:
            rel = (key.relative_to(root.resolve())
                   if key.is_relative_to(root.resolve()) else f)
            errors.append(Finding(PARSE_ERROR_RULE, Path(rel).as_posix(),
                                  e.lineno or 0, e.offset or 0, "",
                                  f"syntax error: {e.msg}"))
            continue
        (tests if mod.is_test else sources).append(mod)
    return sources, tests, errors


def run_analysis(paths: Sequence, *, root=None,
                 rules: Optional[Sequence[Rule]] = None,
                 extra_test_paths: Sequence = ()) -> List[Finding]:
    """Run gflint over `paths` and return the surviving findings, sorted.

    ``root`` anchors the relative paths in findings (default: cwd).  The
    evidence corpus is every ``test_torch_*.py`` found under `paths`, plus
    every test file under ``extra_test_paths`` when the caller names some,
    else the ``tests/test_torch_*.py`` files beside ``root``: the
    reference's tests are never evidence for the port's ops.
    """
    from repro_torch.analysis.rules import default_rules

    root = Path(root) if root is not None else Path.cwd()
    sources, tests, findings = collect_modules([Path(p) for p in paths],
                                               root)
    tests = [m for m in tests if is_port_test(m.path)]
    extra = list(extra_test_paths)
    auto = not extra
    if auto:
        auto_tests = root / "tests"
        if auto_tests.is_dir() and not any(
                Path(p).resolve() == auto_tests.resolve() for p in paths):
            extra.append(auto_tests)
    if extra:
        _, more_tests, more_errors = collect_modules(
            [Path(p) for p in extra], root)
        known = {m.path for m in tests}
        tests += [m for m in more_tests if m.path not in known
                  and (not auto or is_port_test(m.path))]
        findings += [e for e in more_errors
                     if not auto or is_port_test(e.path)]

    ctx = AnalysisContext(sources, tests, root)
    for rule in (rules if rules is not None else default_rules()):
        findings.extend(rule.check(ctx))

    by_path = {m.path: m for m in sources}
    kept: List[Finding] = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.line_disabled(f.line, f.rule):
            continue
        kept.append(f)
    return sorted(set(kept))
