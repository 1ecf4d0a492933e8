"""Client-level secure aggregation (eq. 23): pairwise antithetic masks.

Mirrors ``repro.core.privacy.secure_agg`` (the reference path the engines
take with ``use_kernels`` off): every pair (j < k) of participating clients
shares a Gaussian stream; client j adds ``+PRG(j,k)`` and client k adds
``-PRG(j,k)``, so the masks cancel exactly in the server sum.

The streams are standard normals ``[..., L(L-1)/2, dim]`` in the
row-major (j < k) pair order of ``triu_indices`` — drawn from a
Generator, or handed in (the tests pass the reference's own draws, which
it takes from ``fold_in(fold_in(key, j), k)``).  Leading dims batch
servers.  :func:`masked_client_mean_dropout_vec` is the survivor mean the
mechanisms take when clients drop out mid-round.  The reference's O(L^2)
loop versions — :func:`pairwise_masks`, :func:`masked_client_mean_with_dropout`
— are kept too, as in the reference, as the oracles the vectorized ones
are held against; they and :func:`masked_client_mean` take one server's
``[L, D]`` updates.
"""
from __future__ import annotations

import torch

from repro_torch.core.privacy.noise import f32_scalar


def num_pairs(L: int) -> int:
    return L * (L - 1) // 2


def _normals(L: int, dim: int, normals, generator) -> torch.Tensor:
    """The pair streams [..., L(L-1)/2, dim]: given, or drawn."""
    if normals is None:
        if generator is None:
            raise ValueError("pair streams need normals or a generator")
        normals = torch.randn((num_pairs(L), dim), generator=generator,
                              device=generator.device)
    if normals.shape[-2:] != (num_pairs(L), dim):
        raise ValueError(f"pair normals {tuple(normals.shape)} do not match "
                         f"L={L}, dim={dim}")
    return normals


def pair_stream_matrix(L: int, dim: int, scale, *,
                       normals: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Antisymmetric pair-stream tensor S [..., L, L, dim].

    ``S[j, k] = scale * PRG(j, k)`` for ``j < k`` and ``S[k, j] = -S[j, k]``;
    ``mask_j = S[j].sum(0)``."""
    normals = _normals(L, dim, normals, generator)
    vals = (normals.to(torch.float32)
            * f32_scalar(scale, normals.device)).to(dtype)
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


def masked_client_mean_dropout_vec(updates: torch.Tensor, alive: torch.Tensor,
                                   scale, *,
                                   normals: torch.Tensor | None = None,
                                   generator: torch.Generator | None = None
                                   ) -> torch.Tensor:
    """Survivor-renormalized aggregation (7) under mid-round client dropout.

    Bonawitz-style recovery: masks between two survivors cancel in the sum,
    masks between two dead clients never arrive, and each orphaned
    alive<->dead stream is rebuilt from the survivors' seed shares and
    subtracted; the sum is then divided by the survivor count, so the
    result is the exact mean over alive clients.

    updates: [..., L, D]; alive: [..., L] bool -> [..., D].  The pair
    streams come from ``normals`` [..., L(L-1)/2, D] or ``generator``, as
    in :func:`pair_stream_matrix`."""
    L, D = updates.shape[-2:]
    S = pair_stream_matrix(L, D, scale, normals=normals, generator=generator,
                           dtype=updates.dtype)
    masks = S.sum(dim=-2)
    a = alive.to(torch.bool)
    total = torch.where(a[..., None], updates + masks, 0.0).sum(dim=-2)
    orphan = a[..., :, None] & ~a[..., None, :]      # j alive, k dead
    repair = torch.where(orphan[..., None], S, 0.0).sum(dim=(-3, -2))
    n_alive = torch.clamp(a.sum(dim=-1, keepdim=True), min=1)
    return (total - repair) / n_alive


def _pair_mask(normals: torch.Tensor, p: int, scale, dtype) -> torch.Tensor:
    """``scale * PRG(j, k)`` of the p-th pair, as the reference draws it."""
    return (normals[p].to(torch.float32)
            * f32_scalar(scale, normals.device)).to(dtype)


def pairwise_masks(num_clients: int, dim: int, mask_scale=1.0, *,
                   normals: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Masks [L, dim] whose columns sum exactly to zero:

        mask_k = sum_{j<k} -PRG(j,k) + sum_{j>k} +PRG(k,j)

    The O(L^2) loop reference (the reference keeps it as the oracle of
    :func:`pairwise_masks_vec`, which agrees to float addition order)."""
    L = num_clients
    normals = _normals(L, dim, normals, generator)
    masks = torch.zeros((L, dim), dtype=dtype, device=normals.device)
    p = 0
    for j in range(L):
        for k in range(j + 1, L):
            m = _pair_mask(normals, p, mask_scale, dtype)
            masks[j] += m
            masks[k] -= m
            p += 1
    return masks


def masked_client_mean(updates: torch.Tensor, mask_scale=1.0, *,
                       normals: torch.Tensor | None = None,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """Server aggregation (7) with secure-agg masks: [L, D] -> [D], the
    mean over clients of (update + mask).  The masks cancel exactly, so
    this is ``updates.mean(0)`` up to float addition order — the server
    learns only the aggregate."""
    L, dim = updates.shape
    # the masks cancel exactly: a zero net release, nothing to charge
    masks = pairwise_masks_vec(  # gflint: disable=GFL002
        L, dim, mask_scale, normals=normals, generator=generator,
        dtype=updates.dtype)
    return (updates + masks).mean(dim=0)


def masked_client_mean_with_dropout(updates: torch.Tensor,
                                    alive: torch.Tensor, mask_scale=1.0, *,
                                    normals: torch.Tensor | None = None,
                                    generator: torch.Generator | None = None
                                    ) -> torch.Tensor:
    """Aggregation (7) when some clients DROP OUT mid-round, the O(L^2)
    loop reference of :func:`masked_client_mean_dropout_vec`.

    Sum the masked updates of alive clients, then remove every mask
    stream between an alive and a dead client (streams between two dead
    clients never arrive; streams between two alive ones cancel), and
    divide by the survivor count.  updates: [L, D]; alive: [L] bool."""
    L, D = updates.shape
    normals = _normals(L, D, normals, generator)
    a = alive.to(torch.bool)
    masks = pairwise_masks(L, D, mask_scale, normals=normals,
                           dtype=updates.dtype)
    total = torch.where(a[:, None], updates + masks, 0.0).sum(dim=0)
    p = 0
    for j in range(L):
        for k in range(j + 1, L):
            m = _pair_mask(normals, p, mask_scale, updates.dtype)
            orphan_j = a[j] & ~a[k]          # +m arrived without -m
            orphan_k = a[k] & ~a[j]          # -m arrived without +m
            total = (total - torch.where(orphan_j, m, 0.0)
                     + torch.where(orphan_k, m, 0.0))
            p += 1
    n_alive = torch.clamp(a.sum(), min=1)
    return total / n_alive
