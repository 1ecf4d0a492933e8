"""Optimizers as optax-style ``init`` / ``update`` pairs over trees (nested
dicts and lists) of tensors (mirrors ``repro/optim/optimizers.py``).

The GFL path uses plain SGD (the paper's algorithm keeps no optimizer
state); momentum, Adam and AdamW serve small trainers.  Adam keeps its
moments in f32 and places eps and the bias corrections as the reference
does (``m / bc1 / (sqrt(v / bc2) + eps)``), which ``torch.optim.Adam``
does not, so a run can be held against the reference step by step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping its dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step, lr) -> (updates, state)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step, lr):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step, lr):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step, lr):
        t = _f32(step) + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        bc1 = 1 - torch.pow(_f32(b1), t)
        bc2 = 1 - torch.pow(_f32(b2), t)

        def upd(m, v, p):
            step_ = m / bc1.to(m.device) / (torch.sqrt(v / bc2.to(m.device))
                                            + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(torch.float32)
            return (-lr * step_).to(p.dtype)

        return tree_map(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    return adam(b1, b2, eps, weight_decay)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgd":
        return sgd()
    if cfg.optimizer == "momentum":
        return momentum(cfg.beta1)
    if cfg.optimizer == "adam":
        return adam(cfg.beta1, cfg.beta2)
    if cfg.optimizer == "adamw":
        return adamw(cfg.beta1, cfg.beta2, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
