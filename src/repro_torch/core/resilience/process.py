"""Time-varying topology process: per-round effective combination matrices
(a copy of the reference's ``core/resilience/process.py``: pure numpy,
realizations equal bit for bit).

A :class:`TopologyProcess` owns a base doubly-stochastic combination matrix
``A`` (Assumption 1) and a :class:`~repro_torch.core.resilience.faults.FaultModel`
and, for each round ``i``, realizes an *effective* matrix ``A_i``:

  1. sample server outages (a down server loses all incident links) and
     i.i.d. link drops over the base edges;
  2. repair connectivity: re-add a minimal random set of the dropped edges
     until the realized graph is connected again.  A partitioned graph has
     spectral gap 1 and the collective cannot complete at all — production
     runtimes block and retry such links, so the repair models the retry
     path while the realized gap still degrades with the failure rate;
  3. fold each dropped edge's weight back into BOTH endpoint diagonals
     (Metropolis re-normalization): ``A_i[p, p] = A[p, p] + sum of the
     dropped weights in row p``.  Surviving entries keep their base weights
     bit-exactly, so a zero-probability fault model realizes ``A_i == A``
     exactly and dead links are zero-weight entries the mesh combine can
     skip or permute with weight 0.

Every realized ``A_i`` is therefore symmetric, doubly stochastic, has a
strictly positive diagonal (Metropolis max-degree weights leave slack) and
is connected — i.e. Assumption 1 (``spectral_gap(A_i) < 1``) holds every
round, matching the time-varying analysis of arXiv:2203.07105.  The gap
*trajectory* ``spectral_gap(A_i)`` is exposed so experiments can report how
failures slow consensus (and, per arXiv:2312.07956, shift the realized
privacy bound).

Realizations are a pure function of ``(seed, round)`` — re-running a round
re-realizes the identical topology, which is what makes fault-injected runs
reproducible and resumable.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.resilience.faults import (
    STREAM_STRAGGLER,
    STREAM_TOPOLOGY,
    FaultModel,
    client_dropout_mask,
    fault_stream_rng,
    parse_fault_spec,
)
from repro_torch.core.topology import spectral_gap, validate_combination_matrix


class RoundRealization(NamedTuple):
    """One round's effective topology."""
    A: np.ndarray          # [P, P] effective doubly-stochastic matrix
    link_mask: np.ndarray  # [P, P] bool, True where the base edge survived
    straggler: np.ndarray  # [P] bool, servers re-announcing stale psi
    gap: float             # spectral_gap(A)


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def fold_dropped_links(A: np.ndarray, link_mask: np.ndarray) -> np.ndarray:
    """Zero the dropped off-diagonal entries of ``A`` and fold their weight
    into the diagonal.  Exact: surviving entries are untouched and the
    all-True mask returns ``A`` bit-for-bit (the folded correction is a sum
    of exact zeros)."""
    off = ~np.eye(A.shape[0], dtype=bool)
    dropped = off & ~link_mask
    A_i = np.where(dropped, 0.0, A)
    # symmetric drop => each row's lost mass returns to its own diagonal
    np.fill_diagonal(A_i, np.diagonal(A) + np.where(dropped, A, 0.0).sum(1))
    return A_i


class TopologyProcess:
    """Per-round fault realizations over a fixed base combination matrix.

    ``base_A`` must satisfy Assumption 1 (use
    :func:`repro_torch.core.topology.combination_matrix`); the base edge set is
    read off its nonzero off-diagonal entries, so product graphs (the mesh
    trainer's ``kron(A_pod, A_data)``) work unchanged.
    """

    def __init__(self, base_A: np.ndarray, fault: FaultModel | str = "none",
                 *, seed: int = 0, validate: bool = True):
        self.base_A = np.asarray(base_A, np.float64)
        self.fault = (parse_fault_spec(fault) if isinstance(fault, str)
                      else fault)
        self.seed = seed
        self._validate = validate
        P = self.base_A.shape[0]
        off = ~np.eye(P, dtype=bool)
        self.base_mask = off & (self.base_A > 0)
        iu, ju = np.nonzero(np.triu(self.base_mask))
        self._edges = list(zip(iu.tolist(), ju.tolist()))  # base edge list
        # realizations are pure in (seed, round) and include an O(P^3)
        # eigendecomposition — memoize so the training loop and the gap
        # trajectory (run_gfl(record_gaps=True)) share one realization
        self._memo: dict[int, RoundRealization] = {}
        self._base_gap: float | None = None

    @property
    def P(self) -> int:
        return self.base_A.shape[0]

    @property
    def static(self) -> bool:
        """True when every round realizes the base matrix exactly."""
        return not self.fault.perturbs_topology

    # ------------------------------------------------------------ sampling

    def _rng(self, round_idx: int, stream: int) -> np.random.Generator:
        """Deterministic per-(round, stream) generator (shared stream
        discipline — see repro_torch.core.resilience.faults.fault_stream_rng)."""
        return fault_stream_rng(self.seed, stream, round_idx)

    def realize(self, round_idx: int) -> RoundRealization:
        """Effective topology for round ``round_idx`` (memoized)."""
        round_idx = int(round_idx)
        hit = self._memo.get(round_idx)
        if hit is not None:
            return hit
        real = self._realize(round_idx)
        if len(self._memo) >= self._MEMO_CAP:   # FIFO bound: [P,P] arrays
            self._memo.pop(next(iter(self._memo)))
        self._memo[round_idx] = real
        return real

    _MEMO_CAP = 4096

    def _realize(self, round_idx: int) -> RoundRealization:
        f = self.fault
        straggler = self._straggler_proposal(round_idx)
        if self.static:
            if self._base_gap is None:   # one eigendecomposition, not
                self._base_gap = (spectral_gap(self.base_A)  # one per round
                                  if self.P > 1 else 0.0)
            return RoundRealization(self.base_A, self.base_mask.copy(),
                                    straggler, self._base_gap)

        rng = self._rng(round_idx, stream=STREAM_TOPOLOGY)
        P = self.P
        up = (rng.random(P) >= f.outage) if f.outage > 0 else np.ones(P, bool)
        alive: list[tuple[int, int]] = []
        dropped: list[tuple[int, int]] = []
        # one uniform draw per base edge, in fixed edge order (deterministic)
        edge_u = rng.random(len(self._edges))
        for (j, k), u in zip(self._edges, edge_u):
            if up[j] and up[k] and u >= f.link_drop:
                alive.append((j, k))
            else:
                dropped.append((j, k))

        # connectivity repair: re-add a minimal random set of dropped edges
        uf = _UnionFind(P)
        components = P
        for j, k in alive:
            components -= uf.union(j, k)
        if components > 1:
            order = rng.permutation(len(dropped))
            for idx in order:
                j, k = dropped[idx]
                if uf.union(j, k):
                    alive.append((j, k))
                    components -= 1
                    if components == 1:
                        break

        mask = np.zeros((P, P), bool)
        for j, k in alive:
            mask[j, k] = mask[k, j] = True
        A_i = fold_dropped_links(self.base_A, mask)
        gap = spectral_gap(A_i) if P > 1 else 0.0
        if self._validate:
            validate_combination_matrix(A_i, gap=gap)
        return RoundRealization(A_i, mask, straggler, gap)

    def _straggler_proposal(self, round_idx: int) -> np.ndarray:
        """Servers *proposing* to straggle this round (the runtime may
        force a refresh once a server's psi hits the staleness bound)."""
        if self.fault.straggler <= 0:
            return np.zeros(self.P, bool)
        rng = self._rng(round_idx, stream=STREAM_STRAGGLER)
        return rng.random(self.P) < self.fault.straggler

    def client_alive(self, round_idx: int, L: int) -> np.ndarray:
        """[P, L] participation mask for the round's sampled clients (the
        shared realization — see
        :func:`repro_torch.core.resilience.faults.client_dropout_mask`)."""
        if self.fault.client_dropout <= 0:
            return np.ones((self.P, L), bool)
        return client_dropout_mask(self.seed, round_idx, self.P, L,
                                   self.fault.client_dropout)

    # ---------------------------------------------------------- trajectory

    def gap_trajectory(self, rounds: int) -> np.ndarray:
        """``spectral_gap(A_i)`` for rounds ``0..rounds-1``."""
        return np.asarray([self.realize(i).gap for i in range(rounds)])
