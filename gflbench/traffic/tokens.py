"""The federated LM's token traffic, drawn from the run's seed on the host.

A synthetic language: a zipf unigram (p(rank) ~ 1/rank) mixed with a fixed
bigram successor table, so a model has structure to fit.  Token t of a row
is the successor of token t - 1 with probability ``bigram_frac``, else a
fresh unigram draw.  Round ``step`` draws every client's rows at once from
its own numpy generator, so every row of a run differs and a seed gives
the same rows on every run.  The draw is made on the host inside each
round, as a user's data loader's would be.
"""
from __future__ import annotations

import numpy as np
import torch


class TokenStream:
    def __init__(self, vocab: int, seed: int, bigram_frac: float):
        self.vocab, self.seed, self.bigram_frac = vocab, seed, bigram_frac
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
        self.succ = rng.permutation(vocab)
        p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = 1.0

    def rows(self, step: int, rows: int, length: int) -> np.ndarray:
        """[rows, length] int64 token rows of round ``step``."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, 2, step]))
        draws = np.minimum(np.searchsorted(self.cdf, rng.random(
            (rows, length)), side="right"), self.vocab - 1)
        bigram = rng.random((rows, length)) < self.bigram_frac
        toks = np.empty_like(draws)
        toks[:, 0] = draws[:, 0]
        for t in range(1, length):
            toks[:, t] = np.where(bigram[:, t], self.succ[toks[:, t - 1]],
                                  draws[:, t])
        return toks

    def batch(self, step: int, P: int, L: int, per_client: int, seq: int,
              device) -> dict:
        """Round ``step``'s batch: ``tokens`` and ``labels`` (the tokens
        shifted by one), [P, L, per_client, seq] int64 on ``device``."""
        toks = torch.from_numpy(self.rows(step, P * L * per_client, seq + 1))
        toks = toks.reshape(P, L, per_client, seq + 1).to(device)
        return {"tokens": toks[..., :-1].contiguous(),
                "labels": toks[..., 1:].contiguous()}
