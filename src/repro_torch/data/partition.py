"""Federated data partitioners: split a dataset across (server, client).

A copy of the reference's ``repro/data/partition.py`` (pure numpy): the
same seeds give the same splits, index for index.
"""
from __future__ import annotations

import numpy as np


def uniform_partition(n: int, P: int, K: int, seed: int = 0):
    """Random equal split of n indices into P*K client shards -> [P,K,n//(P*K)].

    The output is rectangular, so the ``n mod (P*K)`` remainder indices are
    intentionally left out (documented, unlike silent float-cut drops);
    use :func:`dirichlet_partition` with ``alpha -> inf`` behavior when every
    index must be assigned."""
    rng = np.random.default_rng(seed)
    per = n // (P * K)
    idx = rng.permutation(n)[: per * P * K]
    return idx.reshape(P, K, per)


def _largest_remainder_counts(props: np.ndarray, total: int) -> np.ndarray:
    """Integer allocation of `total` items proportional to `props`, exact:
    floor the raw shares, then hand the leftover items to the largest
    fractional remainders.  sum(counts) == total always."""
    raw = props * total
    counts = np.floor(raw).astype(int)
    short = total - counts.sum()
    if short > 0:
        order = np.argsort(-(raw - counts))
        counts[order[:short]] += 1
    return counts


def dirichlet_partition(labels: np.ndarray, P: int, K: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 0):
    """Non-IID label-skew split (Dirichlet over classes per client).

    For every class c, client proportions are drawn from Dirichlet(alpha)
    and the class's indices are allocated by largest-remainder rounding —
    every index is assigned to exactly one client (the old float-cut
    implementation truncated cumulative proportions, which both biased mass
    toward the last clients and could drop/duplicate boundary indices).

    ``min_per_client > 0`` additionally redistributes so every client ends
    with at least that many samples (taken from the richest clients) — a
    population generator cannot sample a minibatch from an empty shard.

    Returns a list-of-lists of index arrays [P][K].
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n_clients = P * K
    if min_per_client * n_clients > len(labels):
        raise ValueError(
            f"min_per_client={min_per_client} needs at least "
            f"{min_per_client * n_clients} samples, got {len(labels)}")
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        c_idx = np.nonzero(labels == c)[0]
        rng.shuffle(c_idx)
        props = rng.dirichlet([alpha] * n_clients)
        counts = _largest_remainder_counts(props, len(c_idx))
        stops = np.cumsum(counts)
        for cl, (lo, hi) in enumerate(zip(np.r_[0, stops[:-1]], stops)):
            client_idx[cl].extend(c_idx[lo:hi].tolist())
    assert sum(len(ci) for ci in client_idx) == len(labels)

    if min_per_client > 0:
        # move samples from the richest shards into the starved ones; pop
        # from the tail so donors keep their own class skew at the front
        order = sorted(range(n_clients), key=lambda i: len(client_idx[i]))
        rich = n_clients - 1
        for cl in order:
            while len(client_idx[cl]) < min_per_client:
                while len(client_idx[order[rich]]) <= min_per_client:
                    rich -= 1
                client_idx[cl].append(client_idx[order[rich]].pop())

    return [[np.asarray(client_idx[p * K + k], dtype=np.int64)
             for k in range(K)] for p in range(P)]
