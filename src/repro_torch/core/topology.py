"""Server-graph topologies and combination matrices.

The paper (Assumption 1) requires the combination matrix ``A`` to be symmetric
and doubly stochastic with spectral gap ``lambda = rho(A - 11^T/P) < 1``.
We build such matrices with Metropolis-Hastings weights over several graph
families and expose the spectral gap so experiments can report it.

Pure numpy, carried over from the reference unchanged (the tests hold the
matrices exactly equal); the engines turn ``A`` into a tensor.
"""
from __future__ import annotations

import numpy as np


def _metropolis(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights: symmetric, doubly stochastic for any
    undirected graph; self-loops absorb the residual mass."""
    P = adj.shape[0]
    deg = adj.sum(axis=1)
    A = np.zeros((P, P))
    for p in range(P):
        for m in range(P):
            if p != m and adj[p, m]:
                A[p, m] = 1.0 / (1.0 + max(deg[p], deg[m]))
    for p in range(P):
        A[p, p] = 1.0 - A[p].sum()
    return A


def ring_adjacency(P: int) -> np.ndarray:
    adj = np.zeros((P, P), dtype=bool)
    for p in range(P):
        adj[p, (p + 1) % P] = adj[p, (p - 1) % P] = True
    np.fill_diagonal(adj, False)
    return adj


def torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D torus (wrap-around grid): used for the multi-pod (pod x data) graph."""
    P = rows * cols
    adj = np.zeros((P, P), dtype=bool)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in (idx(r + 1, c), idx(r - 1, c), idx(r, c + 1), idx(r, c - 1)):
                if j != i:
                    adj[i, j] = True
    return adj


def full_adjacency(P: int) -> np.ndarray:
    adj = np.ones((P, P), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def erdos_adjacency(P: int, prob: float = 0.4, seed: int = 0) -> np.ndarray:
    """Erdos-Renyi; resampled until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        u = rng.random((P, P)) < prob
        adj = np.triu(u, 1)
        adj = adj | adj.T
        if _connected(adj):
            return adj
    raise RuntimeError("could not sample a connected ER graph")


def _connected(adj: np.ndarray) -> bool:
    P = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        p = frontier.pop()
        for m in np.nonzero(adj[p])[0]:
            if m not in seen:
                seen.add(m)
                frontier.append(int(m))
    return len(seen) == P


def hypercube_adjacency(P: int) -> np.ndarray:
    """d-dimensional hypercube (P must be a power of two): degree log2(P)
    with O(1/log P) spectral gap decay — much better mixing than a ring at
    the same per-node collective cost scaling."""
    d = int(np.log2(P))
    if 2 ** d != P:
        raise ValueError(f"hypercube needs a power of two, got {P}")
    adj = np.zeros((P, P), dtype=bool)
    for p in range(P):
        for b in range(d):
            adj[p, p ^ (1 << b)] = True
    return adj


def expander_adjacency(P: int, degree: int = 4, seed: int = 0) -> np.ndarray:
    """Random regular-ish expander (union of `degree`/2 random ring
    permutations): near-constant spectral gap."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((P, P), dtype=bool)
    for _ in range(max(degree // 2, 1)):
        perm = rng.permutation(P)
        for i in range(P):
            a, b = perm[i], perm[(i + 1) % P]
            if a != b:
                adj[a, b] = adj[b, a] = True
    if not _connected(adj):
        adj |= ring_adjacency(P)
    return adj


def combination_matrix(topology: str, P: int, *, rows: int = 0, seed: int = 0
                       ) -> np.ndarray:
    """Build the doubly-stochastic combination matrix for ``topology``."""
    if topology == "ring":
        adj = ring_adjacency(P)
    elif topology == "torus":
        r = rows or int(np.floor(np.sqrt(P)))
        while P % r:
            r -= 1
        adj = torus_adjacency(r, P // r)
    elif topology == "full":
        adj = full_adjacency(P)
    elif topology == "erdos":
        adj = erdos_adjacency(P, seed=seed)
    elif topology == "hypercube":
        adj = hypercube_adjacency(P)
    elif topology == "expander":
        adj = expander_adjacency(P, seed=seed)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    A = _metropolis(adj)
    validate_combination_matrix(A)
    return A


def spectral_gap(A: np.ndarray) -> float:
    """lambda = rho(A - 11^T/P); Assumption 1 requires < 1."""
    P = A.shape[0]
    M = A - np.ones((P, P)) / P
    return float(np.max(np.abs(np.linalg.eigvals(M))))


def validate_combination_matrix(A: np.ndarray, atol: float = 1e-10, *,
                                gap: float | None = None) -> None:
    """Assert Assumption 1.  Pass a precomputed ``gap`` to skip the O(P^3)
    eigendecomposition (per-round fault realizations already have it)."""
    P = A.shape[0]
    if not np.allclose(A, A.T, atol=atol):
        raise ValueError("combination matrix must be symmetric")
    if not np.allclose(A.sum(axis=0), np.ones(P), atol=atol):
        raise ValueError("combination matrix must be doubly stochastic")
    if np.any(A < -atol):
        raise ValueError("combination matrix must be nonnegative")
    if P > 1:
        if gap is None:
            gap = spectral_gap(A)
        if gap >= 1.0 - 1e-12:
            raise ValueError("graph must be connected (spectral gap >= 1)")


def neighbor_lists(A: np.ndarray) -> list[list[int]]:
    """Non-self neighbours of each server (for sparse combine schedules)."""
    P = A.shape[0]
    return [[m for m in range(P) if m != p and A[m, p] > 0] for p in range(P)]


def permute_schedule(topology: str, P: int, *, rows: int = 0) -> list[list[tuple[int, int]]]:
    """Rounds of (src, dst) pairs for collective_permute-based sparse combine.

    Each round is a permutation (every device sends to exactly one device and
    receives from exactly one).  A ring needs 2 rounds (left, right); a torus
    (r x c) needs 4 (up/down/left/right).
    """
    if topology == "ring":
        fwd = [(p, (p + 1) % P) for p in range(P)]
        bwd = [(p, (p - 1) % P) for p in range(P)]
        return [fwd, bwd]
    if topology == "torus":
        r = rows or int(np.floor(np.sqrt(P)))
        while P % r:
            r -= 1
        c = P // r

        def idx(i, j):
            return (i % r) * c + (j % c)

        rounds = []
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rounds.append([(idx(i, j), idx(i + di, j + dj))
                           for i in range(r) for j in range(c)])
        # drop degenerate self-rounds (e.g. rows==1 makes up==down==self or dup)
        uniq, seen = [], set()
        for rd in rounds:
            key = tuple(sorted(rd))
            if all(s != d for s, d in rd) and key not in seen:
                seen.add(key)
                uniq.append(rd)
        return uniq
    raise ValueError(f"no permute schedule for topology {topology!r}")
