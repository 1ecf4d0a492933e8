"""Where every random draw of a run comes from.

The reference derives each draw from a ``jax.random`` key split per round
and per purpose, so the cohort, the client-level noise and the combine
noise of a round are independent streams: switching ``use_kernels`` changes
which client-level draw is made (hash-mask seeds instead of Gaussian pair
streams) without moving the cohort or the combine noise.  Torch cannot
reproduce threefry, so the port keeps the same structure with one
:class:`torch.Generator` per stream, reseeded for each round from
``(seed, round, stream)``:

``cohort``   the round's client and minibatch indices (uniform without
             replacement on the pure path; weighted, with replacement, on
             the population engine's weighted path);
``client``   mask seeds, iid client noise or Gaussian pair streams;
``combine``  the server-level noise.

The invariant: each ``(round, stream)`` is drawn from once (the cohort's
two ``rand`` calls are one draw), and :class:`Draws` raises on a second.
``manual_seed`` sets a generator's Philox offset back to 0, so a reseeded
generator draws exactly the bits a fresh one would.  That is what lets the
round graph (:mod:`repro_torch.core.population.graphed`) replay the draws:
its three generators are registered with the graph, :meth:`Draws.stage`
reseeds them with round i's seeds before round i's replay, and the
captured draws read the seeds and offsets as they stand.

:class:`ReplayDraws` hands out tensors drawn in advance instead — the
parity tests fill it with the reference's own draws, replayed from its key
schedule, so both packages compute on the same numbers.  It runs only
under the eager executor.
"""
from __future__ import annotations

import os
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import SEED_ENV, resolve_device
from repro_torch.core.sampling import sample_clients
from repro_torch.core.privacy.noise import LAPLACE_U_HI, LAPLACE_U_LO
from repro_torch.sanitize import sanitizer_active

STREAMS = {"cohort": 0, "client": 1, "combine": 2}


class Draws:
    """Generator-backed draws: one Generator per stream on the run's
    device, reseeded with ``(seed, round, stream)``'s seed for each draw
    (or once a round by :meth:`stage`); each ``(round, stream)`` is drawn
    from once."""

    def __init__(self, seed=None, device=None):
        if seed is None:
            seed = int(os.environ.get(SEED_ENV, "0"))
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._gens = {s: torch.Generator(device=self.device) for s in STREAMS}
        self._drawn = {s: set() for s in STREAMS}
        self._staged = None

    def round_seed(self, step: int, stream: str) -> int:
        """The seed of ``stream``'s generator in round ``step``."""
        state = np.random.SeedSequence(
            [self.seed, int(step), STREAMS[stream]]).generate_state(1, np.uint64)
        return int(state[0]) & ((1 << 63) - 1)

    def generators(self) -> tuple:
        """The three generators, for registering with a CUDA graph."""
        return tuple(self._gens.values())

    def stage(self, step: int) -> None:
        """Reseed every stream for round ``step`` before a replay of the
        round graph: its captured draws read the generators as they
        stand.  The round's draws made through this object then take the
        generators as staged."""
        for stream, gen in self._gens.items():
            gen.manual_seed(self.round_seed(step, stream))
        self._staged = int(step)

    def generator(self, step: int, stream: str) -> torch.Generator:
        """``stream``'s generator, seeded for round ``step``; raises when
        that round already drew from the stream."""
        step = int(step)
        drawn = self._drawn[stream]
        if step in drawn:
            raise RuntimeError(
                f"round {step} drew from the {stream!r} stream already: each "
                "(round, stream) is drawn from once")
        drawn.add(step)
        gen = self._gens[stream]
        if step != self._staged:
            gen.manual_seed(self.round_seed(step, stream))
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

    def weighted_cohort(self, step: int, probs: torch.Tensor, N: int, L: int,
                        B: int):
        """(client_idx [P, L], batch_idx [P, L, B]): per server L clients
        WITH replacement from ``probs`` [P, K] (the inverse CDF of
        :func:`~repro_torch.core.sampling.sample_clients`), per client B
        samples without replacement; one draw of the ``cohort`` stream."""
        gen = self.generator(step, "cohort")
        P = probs.shape[0]
        u = torch.rand((P, L), generator=gen, device=self.device)
        client_idx = sample_clients(probs, u)
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

    def laplace_uniform_tree(self, step: int, stream: str, shapes) -> list:
        """One draw of ``stream`` for a tree: f32 uniforms in the Laplace
        sampler's open interval, one tensor a leaf of ``shapes``, drawn
        leaf after leaf from the round's generator."""
        gen = self.generator(step, stream)
        return [torch.rand(tuple(s), generator=gen, device=self.device)
                * (LAPLACE_U_HI - LAPLACE_U_LO) + LAPLACE_U_LO
                for s in shapes]

    def normal_tree(self, step: int, stream: str, shapes) -> list:
        """One draw of ``stream`` for a tree: f32 standard normals, one
        tensor a leaf of ``shapes``."""
        gen = self.generator(step, stream)
        return [torch.randn(tuple(s), generator=gen, device=self.device)
                for s in shapes]


class DrawKey(NamedTuple):
    """A mesh train state's randomness, where the reference's state holds
    a ``jax.random`` key: the run's draws and the round the next step
    draws at.  Each step draws at ``round`` and hands ``round + 1`` on, as
    the reference splits its key and threads the first part on, so a
    chain of steps replays; a rerun from one state needs draws that have
    not drawn that round yet (a new :class:`Draws` of the same seed)."""
    draws: Draws
    round: int


class ReplayDraws(Draws):
    """Draws made in advance, handed out in the order the run asks for them.

    ``rounds[i]`` lists round i's draws as ``(stream, kind, value)`` with
    kind one of ``cohort`` or ``weighted_cohort`` (value = (client_idx,
    batch_idx)),
    ``mask_seeds``, ``laplace_uniform`` or ``normal``, or (the mesh
    step's noise trees) ``laplace_uniform_tree`` or ``normal_tree`` (value
    = a list of arrays, one a leaf).  Every request is
    checked against the next entry's round, stream, kind and shape, so a
    run that asks in another order than the reference fails loudly.  In
    the sanitizer's scope (:func:`repro_torch.sanitize.sanitizer_scope`) a
    second request of one ``(round, stream)`` raises, as :class:`Draws`
    always does.  Eager executor only: :meth:`generators`, which the round
    graph registers, raises."""

    def __init__(self, rounds, device=None):
        self.device = resolve_device(device)
        self.seed = None
        self._queue = deque((i, s, k, v) for i, entries in enumerate(rounds)
                            for (s, k, v) in entries)
        self._drawn = set()

    def generators(self):
        raise RuntimeError(
            "ReplayDraws hands out host arrays one request at a time and "
            "cannot feed a replayed CUDA graph: run with executor='eager'")

    def stage(self, step):
        """Nothing to reseed: the draws come in their order (the staged
        rounds run eagerly on replayed draws; a graph cannot)."""

    def _next(self, step, stream, kind, shape=None):
        if sanitizer_active():
            if (int(step), stream) in self._drawn:
                raise RuntimeError(
                    f"round {step} drew from the {stream!r} stream already: "
                    "each (round, stream) is drawn from once")
            self._drawn.add((int(step), stream))
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

    def weighted_cohort(self, step, probs, N, L, B):
        ci, bi = self._next(step, "cohort", "weighted_cohort")
        P, K = probs.shape
        if np.shape(ci) != (P, L) or np.shape(bi) != (P, L, B):
            raise RuntimeError("replay shape: weighted cohort")
        if not (0 <= np.min(ci) and np.max(ci) < K and 0 <= np.min(bi)
                and np.max(bi) < N):
            raise RuntimeError("replay range: weighted cohort")
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

    def _tree(self, step, stream, kind, shapes):
        v = self._next(step, stream, kind)
        got = [tuple(np.shape(x)) for x in v]
        if got != [tuple(s) for s in shapes]:
            raise RuntimeError(f"replay shape: round {step} {stream}/{kind} "
                               f"asked {[tuple(s) for s in shapes]}, has "
                               f"{got}")
        return [self._tensor(x, torch.float32) for x in v]

    def laplace_uniform_tree(self, step, stream, shapes):
        return self._tree(step, stream, "laplace_uniform_tree", shapes)

    def normal_tree(self, step, stream, shapes):
        return self._tree(step, stream, "normal_tree", shapes)

    @property
    def remaining(self) -> int:
        return len(self._queue)
