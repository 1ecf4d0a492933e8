"""Gradient clipping: global-norm (training stability) and per-leaf
B-ball projection (mirrors ``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.optim.optimizers import tree_map


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _leaves(tree)))


def _coef(nrm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(nrm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """(the tree scaled onto the ``max_norm`` ball, its norm before).
    ``norm``: the norm to clip by, where the caller has it (a tree whose
    leaves are blocks of a model split over ranks); the tree's own
    otherwise."""
    nrm = global_norm(tree) if norm is None else norm
    coef = _coef(nrm, max_norm)
    return tree_map(lambda x: (x * coef).to(x.dtype), tree), nrm


def per_leaf_clip(tree, max_norm: float):
    def clip(x):
        nrm = torch.linalg.vector_norm(x.to(torch.float32))
        return (x * _coef(nrm, max_norm)).to(x.dtype)
    return tree_map(clip, tree)
