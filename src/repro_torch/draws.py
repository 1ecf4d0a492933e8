"""Where every random draw of a run comes from.

The reference derives each draw from a ``jax.random`` key split per round
and per purpose, so the cohort, the client-level noise and the combine
noise of a round are independent streams: switching ``use_kernels`` changes
which client-level draw is made (hash-mask seeds instead of Gaussian pair
streams) without moving the cohort or the combine noise.  Torch cannot
reproduce threefry, so the port keeps the same structure with one
:class:`torch.Generator` per ``(seed, round, stream)``:

``cohort``   the round's client and minibatch indices;
``client``   mask seeds, iid client noise or Gaussian pair streams;
``combine``  the server-level noise.

:class:`ReplayDraws` hands out tensors drawn in advance instead — the
parity tests fill it with the reference's own draws, replayed from its key
schedule, so both packages compute on the same numbers.
"""
from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from repro_torch import SEED_ENV, resolve_device
from repro_torch.core.privacy.noise import LAPLACE_U_HI, LAPLACE_U_LO

STREAMS = {"cohort": 0, "client": 1, "combine": 2}


class Draws:
    """Generator-backed draws: each ``(round, stream)`` gets its own
    Generator seeded from ``(seed, round, stream)``, and is drawn from once."""

    def __init__(self, seed=None, device=None):
        if seed is None:
            seed = int(os.environ.get(SEED_ENV, "0"))
        self.seed = int(seed)
        self.device = resolve_device(device)

    def generator(self, step: int, stream: str) -> torch.Generator:
        state = np.random.SeedSequence(
            [self.seed, int(step), STREAMS[stream]]).generate_state(1, np.uint64)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0]) & ((1 << 63) - 1))
        return gen

    def cohort(self, step: int, P: int, K: int, N: int, L: int, B: int):
        """(client_idx [P, L], batch_idx [P, L, B]): per server L clients
        WITHOUT replacement, per client B samples without replacement."""
        gen = self.generator(step, "cohort")
        keys = torch.rand((P, K), generator=gen, device=self.device)
        client_idx = torch.argsort(keys, dim=1, stable=True)[:, :L]
        keys = torch.rand((P, L, N), generator=gen, device=self.device)
        batch_idx = torch.argsort(keys, dim=2, stable=True)[..., :B]
        return client_idx, batch_idx

    def mask_seeds(self, step: int, P: int) -> torch.Tensor:
        """[P] per-server hash-mask seeds in [0, 2^31 - 1) (int64)."""
        gen = self.generator(step, "client")
        return torch.randint(0, 2 ** 31 - 1, (P,), generator=gen,
                             device=self.device)

    def laplace_uniform(self, step: int, stream: str, shape) -> torch.Tensor:
        """f32 uniforms in the Laplace sampler's open interval."""
        gen = self.generator(step, stream)
        u = torch.rand(tuple(shape), generator=gen, device=self.device)
        return u * (LAPLACE_U_HI - LAPLACE_U_LO) + LAPLACE_U_LO

    def normal(self, step: int, stream: str, shape) -> torch.Tensor:
        """f32 standard normals."""
        gen = self.generator(step, stream)
        return torch.randn(tuple(shape), generator=gen, device=self.device)


class ReplayDraws(Draws):
    """Draws made in advance, handed out in the order the run asks for them.

    ``rounds[i]`` lists round i's draws as ``(stream, kind, value)`` with
    kind one of ``cohort`` (value = (client_idx, batch_idx)),
    ``mask_seeds``, ``laplace_uniform`` or ``normal``.  Every request is
    checked against the next entry's round, stream, kind and shape, so a
    run that asks in another order than the reference fails loudly."""

    def __init__(self, rounds, device=None):
        self.device = resolve_device(device)
        self.seed = None
        self._queue = deque((i, s, k, v) for i, entries in enumerate(rounds)
                            for (s, k, v) in entries)

    def _next(self, step, stream, kind, shape=None):
        if not self._queue:
            raise RuntimeError(f"no replayed draw left for round {step} "
                               f"({stream}/{kind})")
        i, s, k, v = self._queue.popleft()
        if (i, s, k) != (int(step), stream, kind):
            raise RuntimeError(f"replay order: asked for round {step} "
                               f"{stream}/{kind}, next is round {i} {s}/{k}")
        if shape is not None and tuple(np.shape(v)) != tuple(shape):
            raise RuntimeError(f"replay shape: round {step} {stream}/{kind} "
                               f"asked {tuple(shape)}, has {np.shape(v)}")
        return v

    def _tensor(self, v, dtype):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=self.device)

    def cohort(self, step, P, K, N, L, B):
        ci, bi = self._next(step, "cohort", "cohort")
        if np.shape(ci) != (P, L) or np.shape(bi) != (P, L, B):
            raise RuntimeError("replay shape: cohort")
        return self._tensor(ci, torch.int64), self._tensor(bi, torch.int64)

    def mask_seeds(self, step, P):
        v = self._next(step, "client", "mask_seeds", (P,))
        return self._tensor(np.asarray(v).astype(np.int64), torch.int64)

    def laplace_uniform(self, step, stream, shape):
        return self._tensor(self._next(step, stream, "laplace_uniform", shape),
                            torch.float32)

    def normal(self, step, stream, shape):
        return self._tensor(self._next(step, stream, "normal", shape),
                            torch.float32)

    @property
    def remaining(self) -> int:
        return len(self._queue)
