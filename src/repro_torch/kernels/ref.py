"""Plain torch versions of the on-path ops, mirroring ``repro/kernels/ref.py``.

These compute what the reference's pure-jnp oracles compute, in the same
structure, so the CPU tests hold them against the reference and the chip
check holds the CUDA kernels against them.  Nothing on the main path calls
them when a card is present.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.secure_agg import net_mask_stream


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32: TF32 would keep ~3 decimal digits and
    break the 1e-5 parity contract, so it is switched off explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


def graph_combine_ref(a_t: torch.Tensor, psi: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """out = A^T (psi + g) - g  (eq. 8 with eq. 24 noise structure)."""
    mixed = matmul_f32(a_t.to(torch.float32), (psi + g).to(torch.float32))
    return (mixed - g.to(torch.float32)).to(psi.dtype)


def hash_net_mask_fold(seeds: torch.Tensor, noise_w: torch.Tensor, D: int,
                       scale) -> torch.Tensor:
    """Per server, the folded net pairwise hash-stream masks
    ``sum_k noise_w[p, k] * mask_k`` -> [P, D].

    ``seeds`` [P] (uint32 values), ``noise_w`` [P, L]; a client with
    ``noise_w <= 0`` is dead and its pair streams never arrive.  One
    [L, D] stream block per (server, owner), as in the reference."""
    P, L = noise_w.shape
    idx = torch.arange(D, device=noise_w.device)
    nw = noise_w.to(torch.float32)
    out = torch.zeros((P, D), dtype=torch.float32, device=noise_w.device)
    for p in range(P):
        alive = nw[p] > 0
        for k in range(L):
            out[p] += nw[p, k] * net_mask_stream(k, idx, seeds[p], scale, L,
                                                 alive)
    return out


def round_fold_ref(w: torch.Tensor, grads: torch.Tensor, *, mu: float,
                   bound: float, pre_w: torch.Tensor, fold_w: torch.Tensor,
                   noise_w: torch.Tensor, mode: str = "none",
                   sigma: float = 0.0, seeds: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None):
    """Fused round-fold oracle: clip -> update -> privatize -> fold.

    w: [P, D] or [P, L, D]; grads: [P, L, D]; pre_w / fold_w / noise_w:
    [P, L].  Returns (psi [P, D] in w.dtype, sq [P, L] raw squared grad
    norms) — the contract of :func:`repro_torch.kernels.ops.round_fold`."""
    P, L, D = grads.shape
    g32 = grads.to(torch.float32)
    sq = (g32 * g32).sum(dim=-1)
    pre = pre_w.to(torch.float32)
    nrm = pre * torch.sqrt(sq)
    if bound > 0:
        coef = torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)
    else:
        coef = torch.ones_like(nrm)
    ss = mu * coef * pre
    wb = w.to(torch.float32)
    if w.dim() == 2:
        wb = wb[:, None, :]
    upd = wb - ss[..., None] * g32
    fw = fold_w.to(torch.float32)
    fwn = fw / torch.clamp(fw.sum(dim=1, keepdim=True), min=1e-12)
    psi = (fwn[..., None] * upd).sum(dim=1)
    nw = noise_w.to(torch.float32)
    if mode == "laplace":
        psi = psi + (nw[..., None] * noise.to(torch.float32)).sum(dim=1)
    elif mode == "mask":
        psi = psi + hash_net_mask_fold(seeds, nw, D, sigma)
    elif mode != "none":
        raise ValueError(f"unknown fold mode {mode!r}")
    return psi.to(w.dtype), sq
