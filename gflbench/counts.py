"""Operations and bytes that a cell's work needs, counted from its shapes.

These are the yardstick of the rooflines and utilization shares: what the
algorithm needs, each input byte read once and each output byte written
once, whatever passes an implementation makes, so that a later design is
held to the same count.
"""
from __future__ import annotations


def fold_bytes(P: int, L: int, D: int, itemsize: int = 4) -> int:
    """The client fold (eqs. 6-7) over [P, L, D] gradients: the gradients
    and the servers' [P, D] parameters read once, psi [P, D] written once.
    The pairwise masks cost no bytes: they are made from a seed."""
    return (P * L * D + 2 * P * D) * itemsize


def combine_bytes(P: int, D: int, itemsize: int = 4) -> int:
    """The graph combine under homomorphic noise (eqs. 8, 24): A [P, P]
    f32, psi [P, D] and g [P, D] read once; the [P, D] result written
    once."""
    return P * P * 4 + 3 * P * D * itemsize


def lm_flops_per_token(n_params: int, layers: int, d_model: int,
                       seq: int) -> float:
    """Training FLOPs a token, forward and backward, no recompute: 6 N for
    the parameters (a tied embedding counts once, as the head's product)
    and PaLM's attention term 12 layers d seq (Chowdhery et al. 2022,
    appendix B; the causal mask not halved)."""
    return 6.0 * n_params + 12.0 * layers * d_model * seq


def logistic_round_flops(P: int, L: int, B: int, M: int) -> float:
    """One Section V round's arithmetic at its shapes: the logistic
    gradients (margins, the sigmoid's coefficient, the mean over B, the
    ridge term), the clip to B, the fold (eqs. 6-7) and the combine's
    [P, P] x [P, M] product with the noise added and taken off."""
    grads = 4 * P * L * B * M + 4 * P * L * B + 2 * P * L * M
    clip = 2 * P * L * M + 4 * P * L
    fold = 4 * P * L * M
    combine = 2 * P * P * M + 2 * P * M
    return float(grads + clip + fold + combine)
