"""Optimizers, schedules and clipping as functional ``init`` / ``update``
pairs over trees of tensors (mirrors ``repro/optim``)."""
from repro_torch.optim.clip import (
    clip_by_global_norm,
    global_norm,
    per_leaf_clip,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    make_optimizer,
    momentum,
    sgd,
    tree_map,
)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = [
    "Optimizer", "sgd", "momentum", "adam", "adamw", "make_optimizer",
    "constant", "cosine_decay", "warmup_cosine",
    "clip_by_global_norm", "global_norm", "per_leaf_clip", "tree_map",
]
