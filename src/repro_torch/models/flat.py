"""A flat view of a :class:`~repro_torch.models.model.Model`'s parameters:
the counterpart of ``jax.flatten_util.ravel_pytree`` on the reference's
param tree, as ``examples/federated_lm.py`` uses it.

The order is ``ravel_pytree``'s: dict keys sorted at every level, and each
stacked block leaf (``blocks/attn/w_q``, [n_layers, ...] in the reference)
laid out layer after layer before the next leaf.  The port keeps one dict
a layer (``blocks.3.attn.w_q``), so a stacked leaf gathers across the
layers; DeepSeek's leading dense layers form the reference's
``dense_blocks`` stack.  The order matters beyond parity: the fold
kernel's mask mode hashes the flat index, so it decides which parameter
gets which mask bits.  A tree of mixed dtypes is promoted as
``ravel_pytree`` promotes it, and :meth:`FlatView.unravel` casts each leaf
back.

    view = FlatView(model)
    w = view.ravel(model)                       # [D]
    with view.bind(model, w):                   # the model reads w
        loss, aux = model.loss(tokens, labels)
    g = view.grad(model, w, lambda: model.loss(tokens, labels)[0])  # [D]
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import torch
from torch import nn

# the port's block stacks: module attribute -> the reference's stack key
_STACKS = ("blocks", "enc_blocks")


class Leaf(NamedTuple):
    path: tuple          # the reference's key path
    names: tuple         # the module's parameter names, one a layer
    shape: tuple         # one layer's shape
    dtype: torch.dtype
    offset: int          # first flat index
    numel: int           # one layer's elements


def _ref_path(name: str, n_dense: int) -> tuple:
    """(reference key path, layer) of a module parameter name."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        i = int(parts[1])
        stack = parts[0]
        if stack == "blocks" and n_dense:
            stack, i = (("dense_blocks", i) if i < n_dense
                        else ("blocks", i - n_dense))
        return (stack,) + tuple(parts[2:]), i
    return tuple(parts), None


class FlatView:
    """The flat layout of ``model``'s parameters (shapes and dtypes only:
    one view serves any model of the same config)."""

    def __init__(self, model: nn.Module):
        moe = model.cfg.moe
        n_dense = moe.first_dense_layers if moe is not None else 0
        groups: dict = {}
        for name, p in model.named_parameters():
            path, layer = _ref_path(name, n_dense)
            groups.setdefault(path, []).append((layer, name, p))
        leaves, offset = [], 0
        for path in sorted(groups):
            members = sorted(groups[path], key=lambda m: m[0] or 0)
            p0 = members[0][2]
            if any(m[2].shape != p0.shape or m[2].dtype != p0.dtype
                   for m in members):
                raise ValueError(f"{'/'.join(path)}: layers differ in "
                                 "shape or dtype")
            leaf = Leaf(path, tuple(m[1] for m in members), tuple(p0.shape),
                        p0.dtype, offset, p0.numel())
            leaves.append(leaf)
            offset += leaf.numel * len(members)
        self.leaves = leaves
        self.size = offset
        self.dtype = functools.reduce(torch.promote_types,
                                      (lf.dtype for lf in leaves))

    def _segments(self, flat: torch.Tensor):
        """(name, [numel] slice of ``flat``, leaf) in flat order."""
        if flat.shape != (self.size,):
            raise ValueError(f"flat vector of shape {tuple(flat.shape)}, "
                             f"expected ({self.size},)")
        for lf in self.leaves:
            for i, name in enumerate(lf.names):
                a = lf.offset + i * lf.numel
                yield name, flat[a:a + lf.numel], lf

    def ravel(self, model: nn.Module) -> torch.Tensor:
        """The parameters as one [D] vector of the promoted dtype."""
        params = dict(model.named_parameters())
        return torch.cat([params[name].detach().reshape(-1).to(self.dtype)
                          for lf in self.leaves for name in lf.names])

    def unravel(self, flat: torch.Tensor) -> dict:
        """{parameter name: tensor} read from ``flat`` [D]: views where
        the dtypes agree, casts where a leaf's dtype is narrower."""
        return {name: seg.view(lf.shape).to(lf.dtype)
                for name, seg, lf in self._segments(flat)}

    def scatter(self, flat: torch.Tensor, tensors) -> None:
        """Write per-parameter tensors (in :meth:`unravel`'s order) into
        ``flat`` [D], in place."""
        for (_, seg, _), t in zip(self._segments(flat), tensors):
            seg.copy_(t.reshape(-1))

    @contextlib.contextmanager
    def bind(self, model: nn.Module, flat_or_tensors):
        """Let ``model`` read its parameters from a [D] vector (or from
        an :meth:`unravel` dict) inside the block; the module's own
        parameters come back after it."""
        tensors = (self.unravel(flat_or_tensors)
                   if isinstance(flat_or_tensors, torch.Tensor)
                   else flat_or_tensors)
        saved = []
        try:
            for name, t in tensors.items():
                owner, _, key = name.rpartition(".")
                mod = model.get_submodule(owner)
                saved.append((mod, key, mod._parameters[key]))
                mod._parameters[key] = t
            yield model
        finally:
            for mod, key, p in reversed(saved):
                mod._parameters[key] = p

    def grad(self, model: nn.Module, flat: torch.Tensor,
             loss_fn: Callable[[], torch.Tensor],
             out: torch.Tensor | None = None) -> torch.Tensor:
        """The gradient [D] of ``loss_fn()`` (a scalar the model computes)
        at the parameters ``flat``, written into ``out`` when given.  Each
        leaf is its own autograd leaf, so the backward writes each
        gradient once instead of summing D-long slice gradients."""
        leaves = {name: t.detach().requires_grad_()
                  for name, t in self.unravel(flat.detach()).items()}
        with torch.enable_grad(), self.bind(model, leaves):
            loss = loss_fn()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        if out is None:
            out = torch.empty((self.size,), dtype=self.dtype,
                              device=flat.device)
        self.scatter(out, grads)
        return out
