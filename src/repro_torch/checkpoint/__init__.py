"""Crash-atomic pytree checkpoints, npz + json manifest (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
