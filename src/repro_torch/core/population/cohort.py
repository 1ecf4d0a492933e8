"""Cohort scheduling (port of ``repro.core.population.cohort``, pure path).

This slice carries the *pure* scheduler — uniform sampling without
replacement, every client always available, no mid-round dropout — which
is the dense simulator's own draw.  Importance sampling, availability
traces and dropout come with ROADMAP slice 3 and raise here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_LATER = "is not ported yet (ROADMAP slice 3: the population engine's " \
         "weighted path)"


class CohortScheduler:
    """Draws per-round cohorts and keeps the realized-q ledger."""

    def __init__(self, K: int, L: int, P: int):
        if not 1 <= L <= K:
            raise ValueError(f"cohort size L={L} not in [1, K={K}]")
        self.K, self.L, self.P = K, L, P
        self.q_history: list = []

    @classmethod
    def from_config(cls, cfg, *, K: Optional[int] = None,
                    L: Optional[int] = None) -> "CohortScheduler":
        if cfg.cohort != "uniform":
            raise NotImplementedError(f"cohort={cfg.cohort!r} " + _LATER)
        if cfg.fault != "none":
            raise NotImplementedError(f"fault={cfg.fault!r} is not ported "
                                      "yet (ROADMAP slice 2: resilience)")
        K = K or cfg.clients_per_server
        return cls(K, L or cfg.clients_sampled or K, cfg.num_servers)

    @property
    def pure(self) -> bool:
        """True: only the dense simulator's uniform draw is ported."""
        return True

    @property
    def realized_q(self) -> float:
        return float(np.mean(self.q_history)) if self.q_history else 1.0
