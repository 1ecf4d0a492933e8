"""Client-level secure aggregation (eq. 23): pairwise antithetic masks.

Mirrors ``repro.core.privacy.secure_agg`` (the reference path the engines
take with ``use_kernels`` off): every pair (j < k) of participating clients
shares a Gaussian stream; client j adds ``+PRG(j,k)`` and client k adds
``-PRG(j,k)``, so the masks cancel exactly in the server sum.

The streams are standard normals ``[..., L(L-1)/2, dim]`` in the
row-major (j < k) pair order of ``triu_indices`` — drawn from a
Generator, or handed in (the tests pass the reference's own draws, which
it takes from ``fold_in(fold_in(key, j), k)``).  Leading dims batch
servers.
"""
from __future__ import annotations

import torch


def num_pairs(L: int) -> int:
    return L * (L - 1) // 2


def pair_stream_matrix(L: int, dim: int, scale, *,
                       normals: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Antisymmetric pair-stream tensor S [..., L, L, dim].

    ``S[j, k] = scale * PRG(j, k)`` for ``j < k`` and ``S[k, j] = -S[j, k]``;
    ``mask_j = S[j].sum(0)``."""
    if normals is None:
        if generator is None:
            raise ValueError("pair_stream_matrix needs normals or a generator")
        normals = torch.randn((num_pairs(L), dim), generator=generator,
                              device=generator.device)
    if normals.shape[-2:] != (num_pairs(L), dim):
        raise ValueError(f"pair normals {tuple(normals.shape)} do not match "
                         f"L={L}, dim={dim}")
    vals = (normals.to(torch.float32)
            * torch.as_tensor(scale, dtype=torch.float32,
                              device=normals.device)).to(dtype)
    lead = tuple(normals.shape[:-2])
    jj, kk = torch.triu_indices(L, L, offset=1, device=normals.device)
    S = torch.zeros(lead + (L, L, dim), dtype=dtype, device=normals.device)
    S[..., jj, kk, :] = vals
    return S - S.transpose(-3, -2)


def pairwise_masks_vec(L: int, dim: int, scale, *,
                       normals: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Pairwise secure-agg masks [..., L, dim]; columns sum to exactly 0."""
    return pair_stream_matrix(L, dim, scale, normals=normals,
                              generator=generator, dtype=dtype).sum(dim=-2)
