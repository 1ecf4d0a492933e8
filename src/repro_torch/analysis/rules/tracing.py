"""GFL003 — no host sync in a CUDA-graph body.

The port runs its rounds as CUDA graphs (``core/population/graphed.py``)
and the card tests capture its decode steps and kernel wrappers.  A host
sync in a captured body breaks the capture; run eagerly, it blocks the
host on the device once a round.  The rule looks at every function in
the graph scope (:mod:`repro_torch.analysis.rules._graph`: the
``StagedStep.body`` methods, ``run_rounds``' closure, what the sources
and tests capture, and what those call where the callee resolves to one
definition) and flags:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  and ``torch.equal`` / ``allclose``, which read device values on the
  host;
* ``torch.tensor(data, device=d)`` (and ``torch.as_tensor`` of host
  data), a copy from pageable host memory that waits for the device;
* ``.synchronize()`` (``torch.cuda``'s, a stream's, an event's);
* ``float()`` / ``int()`` / ``bool()`` of a tensor;
* ``if`` / ``while`` / ternary / ``assert`` whose truth value is a tensor;
* ``nonzero()`` / ``argwhere()`` / ``masked_select()`` / one-argument
  ``torch.where``, and reading through a boolean mask (``x[x > 0]``),
  whose result's shape depends on the data.

A tensor is a parameter annotated ``torch.Tensor`` or a name bound from a
tensor expression: a torch call (``torch.cuda.*`` and the like aside), a
method of a tensor or a method only tensors have (``.isnan()``,
``.float()``), arithmetic on one.  Structural reads are static and
exempt: ``.shape``, ``.dtype``, ``.device``, ``.size()``, ``.dim()``,
``len``, ``isinstance``, ``is None``.  ``stage()`` is host code by design
and is not in the scope.  The runtime counterpart is the smoke's
``analysis`` phase, which runs each round body once on the card under
``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.framework import (AnalysisContext, Finding,
                                            ModuleInfo, Rule, call_tail)
from repro_torch.analysis.rules._graph import graph_scope
from repro_torch.analysis.rules._torch import (TorchNames, own_nodes,
                                               torch_names)

# method tails that read a device value on the host, whatever the receiver
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
# torch functions / tensor methods that return a host bool of device data
HOST_COMPARES = frozenset({"equal", "allclose"})
DYNAMIC_SHAPE = frozenset({"nonzero", "argwhere", "masked_select"})
CASTS = frozenset({"float", "int", "bool"})
# torch namespaces and functions whose results are not tensors
NON_TENSOR_NS = frozenset({"cuda", "backends", "distributed", "version",
                           "device", "dtype", "Generator", "Size", "finfo",
                           "iinfo", "profiler", "utils", "jit", "compiler",
                           "testing", "_C", "multiprocessing", "hub",
                           "autograd", "nn", "optim", "fx", "library",
                           "random", "overrides", "types"})
NON_TENSOR_FNS = frozenset({"is_tensor", "is_floating_point", "is_complex",
                            "numel", "get_num_threads", "get_default_dtype",
                            "is_grad_enabled", "no_grad", "enable_grad",
                            "inference_mode", "manual_seed", "initial_seed",
                            "seed", "set_num_threads", "equal", "allclose",
                            "is_nonzero", "result_type", "promote_types",
                            "can_cast", "get_device",
                            "is_inference_mode_enabled"})
# structural reads (methods): static under capture
STATIC_METHODS = frozenset({"size", "dim", "numel", "element_size", "stride",
                            "is_contiguous", "data_ptr", "storage_offset",
                            "get_device", "is_floating_point", "nelement",
                            "ndimension", "untyped_storage", "type"})
# methods only a tensor has (not numpy's or a list's): their results are
# tensors whatever the receiver is known to be
TENSOR_METHODS = frozenset({"isnan", "isfinite", "isinf", "isneginf",
                            "isposinf", "nan_to_num", "contiguous",
                            "index_select", "masked_fill", "float", "half",
                            "bfloat16", "long", "int", "bool", "detach",
                            "clone"})
# attributes of a tensor that are tensors
TENSOR_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "grad",
                          "data"})
BOOL_FNS = frozenset({"isfinite", "isnan", "isinf", "isposinf", "isneginf",
                      "logical_and", "logical_or", "logical_not",
                      "logical_xor", "eq", "ne", "gt", "ge", "lt", "le",
                      "isin", "isclose", "bool", "signbit"})


class _Tensors:
    """Which expressions of one function are tensors."""

    def __init__(self, fn: ast.AST, names: TorchNames):
        self.torch = names
        self.names: Set[str] = set()
        self.masks: Set[str] = set()
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None and \
                    "Tensor" in ast.unparse(p.annotation):
                self.names.add(p.arg)
        assigns = [n for n in own_nodes(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign))]
        for _ in range(3):              # propagate through assignments
            for node in assigns:
                if node.value is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                tensor = self.is_tensor(node.value)
                mask = self.is_mask(node.value)
                for t in targets:
                    elts = t.elts if isinstance(t, ast.Tuple) else [t]
                    for e in elts:
                        if not isinstance(e, ast.Name):
                            continue
                        if tensor or (isinstance(t, ast.Tuple)
                                      and self._tuple_of_tensors(node.value)):
                            self.names.add(e.id)
                        if mask:
                            self.masks.add(e.id)

    def _tuple_of_tensors(self, value: ast.AST) -> bool:
        # ``a, b = torch.split(x, ...)`` / ``q, k = t.chunk(2)``
        return isinstance(value, ast.Call) and self.is_tensor(value)

    def torch_call(self, call: ast.Call) -> Optional[str]:
        path = self.torch.resolve(call.func)
        return path if path else None

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            path = self.torch_call(e)
            if path is not None:
                head = path.split(".")[0]
                return head not in NON_TENSOR_NS and \
                    path.split(".")[-1] not in NON_TENSOR_FNS
            if isinstance(e.func, ast.Attribute):
                attr = e.func.attr
                if attr in TENSOR_METHODS:
                    return True
                return (self.is_tensor(e.func.value)
                        and attr not in STATIC_METHODS
                        and attr not in SYNC_METHODS
                        and attr not in HOST_COMPARES)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr in TENSOR_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp) and not isinstance(e.op, ast.Not):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        return False

    def is_mask(self, e: ast.AST) -> bool:
        """A boolean tensor: a comparison of tensors, a logical op or test
        on one, or a name bound from such."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return self.is_tensor(e)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self.is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        if isinstance(e, ast.Call) and call_tail(e) in BOOL_FNS:
            if self.torch_call(e) is not None:
                return True
            return isinstance(e.func, ast.Attribute) and \
                self.is_tensor(e.func.value)
        return False

    def truth(self, test: ast.AST) -> Optional[ast.AST]:
        """The tensor whose truth value ``test`` takes, if any."""
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                hit = self.truth(v)
                if hit is not None:
                    return hit
            return None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.truth(test.operand)
        return test if self.is_tensor(test) else None


def _to_cpu(call: ast.Call, names: TorchNames) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    for arg in list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]:
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return True
        if isinstance(arg, ast.Call) and names.resolve(arg.func) == \
                "device" and arg.args and isinstance(arg.args[0],
                                                     ast.Constant) \
                and arg.args[0].value == "cpu":
            return True
    return False


def _from_host(call: ast.Call, t: "_Tensors", path: Optional[str]) -> bool:
    """``torch.tensor(data, device=d)``, or ``torch.as_tensor`` of data
    that is not a tensor, onto a device that is not the literal "cpu": a
    copy from pageable host memory, which waits for the device."""
    if path not in ("tensor", "as_tensor"):
        return False
    dev = next((kw.value for kw in call.keywords if kw.arg == "device"),
               None)
    if dev is None or (isinstance(dev, ast.Constant) and dev.value == "cpu"):
        return False
    return path == "tensor" or not (call.args and t.is_tensor(call.args[0]))


def _short(node: ast.AST, limit: int = 60) -> str:
    text = ast.unparse(node)
    return text if len(text) <= limit else text[:limit - 3] + "..."


class GraphSyncRule(Rule):
    id = "GFL003"
    title = "no host sync inside a CUDA-graph body"

    def check(self, ctx: AnalysisContext) -> Iterable[Finding]:
        scope = graph_scope(ctx)
        sources = {m.path for m in ctx.source_modules()}
        findings: List[Finding] = []
        for mod, fn in scope.functions():
            if mod.path in sources:
                findings.extend(self._check_fn(mod, fn, torch_names(mod)))
        return findings

    def _check_fn(self, mod: ModuleInfo, fn: ast.AST,
                  names: TorchNames) -> Iterable[Finding]:
        tensors = _Tensors(fn, names)
        for node in own_nodes(fn):
            what = self._sync(node, tensors, names)
            if what is not None:
                yield Finding(
                    self.id, mod.path, node.lineno, node.col_offset,
                    mod.context_of(node),
                    f"host sync in CUDA-graph scope: {what} — a capture "
                    f"fails on it and an eager round blocks on the device; "
                    f"keep the value on the device")

    @staticmethod
    def _sync(node: ast.AST, t: _Tensors,
              names: TorchNames) -> Optional[str]:
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            hit = t.truth(node.test)
            if hit is None:
                return None
            kind = {ast.If: "if", ast.While: "while", ast.IfExp: "ternary",
                    ast.Assert: "assert"}[type(node)]
            return f"python `{kind}` on tensor `{_short(hit)}`"
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            parts = node.slice.elts if isinstance(node.slice, ast.Tuple) \
                else [node.slice]
            if any(t.is_mask(p) for p in parts):
                return (f"boolean-mask index `{_short(node)}` (its shape "
                        f"depends on the data)")
            return None
        if not isinstance(node, ast.Call):
            return None
        tail = call_tail(node)
        path = names.resolve(node.func)
        if (isinstance(node.func, ast.Attribute) and tail in SYNC_METHODS
                and path is None) or path == "cuda.synchronize":
            return f"`{_short(node)}`"
        if _to_cpu(node, names):
            return f"`{_short(node)}` copies to the host"
        if _from_host(node, t, path):
            return (f"`{_short(node)}` copies host data to the device "
                    f"(a synchronous copy)")
        if tail in HOST_COMPARES and (
                path is not None or (isinstance(node.func, ast.Attribute)
                                     and t.is_tensor(node.func.value))):
            return f"`{_short(node)}` reads device values on the host"
        if isinstance(node.func, ast.Name) and tail in CASTS \
                and node.args and t.is_tensor(node.args[0]):
            return f"`{_short(node)}` of a tensor"
        if tail in DYNAMIC_SHAPE and (path is not None or isinstance(
                node.func, ast.Attribute)):
            return f"`{_short(node)}` (its shape depends on the data)"
        if path == "where" and len(node.args) == 1 and not node.keywords:
            return f"`{_short(node)}` (its shape depends on the data)"
        return None
