"""Client populations (port of ``repro.core.population.population``).

This slice carries the dense population — materialized ``[P, K, N, M]``
arrays, the Section-V problem and the regression anchor of the engine.
The lazy ``synthetic:*`` and ``dirichlet:*`` populations come with the
population engine's weighted path (ROADMAP slice 3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class ClientPopulation:
    """A fleet of P x K clients with deterministic shard access.  ``gather``
    materializes exactly the requested cohort ``[P, L, B, M]``."""

    P: int
    num_clients: int
    samples_per_client: int
    dim: int
    rho: float = 0.01
    w_ref: Optional[torch.Tensor] = None

    def gather(self, client_idx: torch.Tensor, batch_idx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """client_idx [P, L] in [0, K); batch_idx [P, L, B] in [0, N) ->
        (h [P, L, B, M], gamma [P, L, B])."""
        raise NotImplementedError


class DensePopulation(ClientPopulation):
    """Materialized arrays as a population; ``gather`` is the reference's
    fancy indexing, index for index."""

    def __init__(self, features: torch.Tensor, labels: torch.Tensor,
                 rho: float = 0.01, w_ref: Optional[torch.Tensor] = None):
        P, K, N, M = features.shape
        self.features = features
        self.labels = labels
        self.P, self.num_clients = P, K
        self.samples_per_client, self.dim = N, M
        self.rho = rho
        self.w_ref = w_ref

    @classmethod
    def from_problem(cls, prob) -> "DensePopulation":
        """Wrap a :class:`repro_torch.core.simulate.LogisticProblem`."""
        return cls(prob.features, prob.labels, rho=prob.rho,
                   w_ref=prob.w_opt)

    def gather(self, client_idx, batch_idx):
        p_idx = torch.arange(self.P, device=client_idx.device)[:, None, None]
        h = self.features[p_idx, client_idx[:, :, None], batch_idx]
        g = self.labels[p_idx, client_idx[:, :, None], batch_idx]
        return h, g
