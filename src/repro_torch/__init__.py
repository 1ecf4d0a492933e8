"""PyTorch + CUDA port of the GFL reproduction (the JAX package ``repro``
stays the reference).

The port imports ``torch`` and never ``jax`` or ``repro``: every module it
needs from the reference, even a pure-numpy one, is carried over here.
Randomness comes from explicit :class:`torch.Generator` objects (the
reference's ``jax.random`` keys) or from tensors drawn in advance, so the
tests can feed the reference's own draws through numpy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a machine without a card raises instead of falling
back to the CPU.
"""
from __future__ import annotations

import os

import torch

#: environment override for the package-wide base seed (see rng)
SEED_ENV = "REPRO_SEED"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    A request for ``cuda`` when no card is visible raises — the port never
    picks the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def rng(seed=None, device=None) -> torch.Generator:
    """The approved seed factory, mirroring ``repro.rng_key``: an explicit
    ``seed`` wins, else the ``REPRO_SEED`` environment variable, else 0."""
    if seed is None:
        seed = int(os.environ.get(SEED_ENV, "0"))
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
