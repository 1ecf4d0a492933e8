"""Deterministic synthetic data pipelines (mirrors
``repro/data/synthetic.py``).

Two generators:
  * the paper's logistic-regression data (Section V), per (server, client);
  * a token-stream LM pipeline (zipf-ish unigram + induction-head bigram
    structure, so models have signal to fit) for the LM trainers, batched
    per (server, client) for the GFL protocol.

The reference draws with threefry keys; torch cannot, so the draws here
come from a :class:`torch.Generator`.  What is not a draw is the
reference's exactly: the successor table (numpy's ``default_rng(seed)
.permutation``) and the composition of the draws into tokens
(:func:`compose_tokens`), which the tests feed with the reference's own
draws.  Every (seed, step, server, client id) gets a generator of its own,
seeded from those four numbers as the reference folds them into its key,
so any batch is reproducible without global state and a virtual client
keeps its data whichever cohort slot samples it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


def logistic_client_data(gen: torch.Generator, P: int, K: int, N: int,
                         M: int, sigma_h_range=(0.5, 1.5)):
    """Section-V generator: labels +-1, h | gamma ~ N(gamma*1, sigma^2 I),
    one sigma a client; on ``gen``'s device."""
    dev = gen.device
    labels = torch.where(torch.rand((P, K, N), generator=gen, device=dev)
                         < 0.5, 1.0, -1.0)
    lo, hi = sigma_h_range
    sigma = lo + (hi - lo) * torch.rand((P, K, 1, 1), generator=gen,
                                        device=dev)
    feats = labels[..., None] + sigma * torch.randn((P, K, N, M),
                                                    generator=gen,
                                                    device=dev)
    return feats, labels


def compose_tokens(draws: torch.Tensor, use_bigram: torch.Tensor,
                   succ: torch.Tensor) -> torch.Tensor:
    """Tokens [B, S] from unigram ``draws`` [B, S] and ``use_bigram`` [B, S]
    (bool): token 0 is the draw, token t the successor of token t - 1
    where ``use_bigram`` is set, else the draw (the reference's scan)."""
    toks = [draws[:, 0]]
    for t in range(1, draws.shape[1]):
        toks.append(torch.where(use_bigram[:, t], succ[toks[-1]],
                                draws[:, t]))
    return torch.stack(toks, dim=1)


@functools.lru_cache(maxsize=None)
def _zipf_cdf(vocab: int, device: torch.device) -> torch.Tensor:
    """The cumulative zipf distribution p(rank) ~ 1/rank, [vocab] f64 (read
    only)."""
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return torch.tensor(cdf, device=device)


@dataclass(frozen=True)
class TokenStream:
    """Synthetic LM distribution: zipf unigram mixed with a deterministic
    bigram successor table (induction structure)."""
    vocab: int
    seed: int = 0
    bigram_frac: float = 0.5

    def succ_table(self, device=None) -> torch.Tensor:
        """The successor table [vocab] int64, the reference's permutation."""
        rng = np.random.default_rng(self.seed)
        return torch.tensor(rng.permutation(self.vocab), dtype=torch.int64,
                            device=device)

    def sample(self, gen: torch.Generator, batch: int,
               seq_len: int) -> torch.Tensor:
        """Tokens [batch, seq_len] int64 on ``gen``'s device."""
        dev = gen.device
        u = torch.rand((batch, seq_len), generator=gen, device=dev,
                       dtype=torch.float64)
        draws = torch.searchsorted(_zipf_cdf(self.vocab, dev), u,
                                   right=True).clamp_(max=self.vocab - 1)
        use_bigram = torch.rand((batch, seq_len), generator=gen,
                                device=dev) < self.bigram_frac
        return compose_tokens(draws, use_bigram, self.succ_table(dev))


def make_batch(stream: TokenStream, gen: torch.Generator, batch: int,
               seq_len: int) -> dict:
    toks = stream.sample(gen, batch, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def client_seed(seed: int, step: int, p: int, cid: int) -> int:
    """The seed of (seed, step, server p, client id cid)'s generator."""
    state = np.random.SeedSequence(
        [int(seed), int(step), int(p), int(cid)]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def federated_token_batches(stream: TokenStream, seed: int, step: int,
                            P: int, L: int, per_client: int, seq_len: int,
                            client_ids=None) -> dict:
    """Batch dict with leading [P, L] dims (``tokens`` and ``labels``,
    [P, L, per_client, seq_len] int64) for the GFL step.

    Each (server, client) pair draws from its own generator, so client
    data is disjoint and reproducible.  ``client_ids`` ([P, L] ints,
    optional) names the population client behind each cohort slot: a
    virtual client keeps the same data whichever round slot samples it;
    the default is the positional identity ``client_ids[p, l] = l``.
    The tokens are drawn on the host's generator, so every device that
    moves them over trains on the same data."""
    if client_ids is not None:
        client_ids = np.asarray(client_ids)
    gen = torch.Generator()
    out = {"tokens": [], "labels": []}
    for p in range(P):
        for l in range(L):
            cid = l if client_ids is None else int(client_ids[p, l])
            gen.manual_seed(client_seed(seed, step, p, cid))
            b = make_batch(stream, gen, per_client, seq_len)
            out["tokens"].append(b["tokens"])
            out["labels"].append(b["labels"])
    return {k: torch.stack(v).reshape(P, L, per_client, seq_len)
            for k, v in out.items()}
