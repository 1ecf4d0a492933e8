"""Graph-homomorphic perturbations (eq. 24-25), the reference combines.

Mirrors ``repro.core.privacy.homomorphic``.  Each takes its noise already
drawn (``g`` [P, D] for the homomorphic combine, [P, P, D] for the iid
per-edge one), so a caller draws from its Generator or replays the
reference's draws.  These are the ``use_kernels=False`` paths; the fused
CUDA combine is :func:`repro_torch.kernels.ops.graph_combine`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import matmul_f32


def homomorphic_combine_noise(A: torch.Tensor, psi: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Server combination (8) with homomorphic noise, eq. 24 folded in:

        w_p = sum_m a_mp psi_m + sum_m a_mp g_m - g_p

    psi, g: [P, D] -> [P, D]."""
    a_t = A.T.to(psi.dtype)
    return matmul_f32(a_t, psi) + (matmul_f32(a_t, g) - g)


def iid_noise_combine(A: torch.Tensor, psi: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Baseline 'standard DP' scheme: independent noise per edge.
    g: [P, P, D], g[m, p] the noise on the edge m -> p."""
    return (matmul_f32(A.T.to(psi.dtype), psi)
            + torch.einsum("mp,mpd->pd", A.to(psi.dtype), g))


def combine_nonprivate(A: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Noise-free server combination (8)."""
    return matmul_f32(A.T.to(psi.dtype), psi)
