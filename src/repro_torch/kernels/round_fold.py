"""K1 ``fold_norms`` and K2 ``fold_apply``: the fused round fold (eqs. 6-7).

Port of the Pallas kernels in ``repro/kernels/round_fold.py``.  The two
streaming passes over the ``[P, L, D]`` gradients are CUDA kernels
(``csrc/fold_norms.cu``, ``csrc/fold_apply.cu``); the tiny ``[P, L]``
clip/weight math between them stays in torch (``ops.round_fold``).  Each
wrapper checks its operands, runs the plain version beside it for CPU
tensors, and launches the kernel for CUDA tensors — no padded copies: the
kernels mask ragged L and D themselves.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import _build
from repro_torch.kernels.common import FLOAT_TYPES, check, on_cuda, stream_handle
from repro_torch.kernels.ref import hash_net_mask_fold

MODES = {"none": 0, "laplace": 1, "mask": 2}
NORMS_CHUNK = 16384       # features per block in fold_norms' first stage
_MAX_GRID_Y = 65535


def fold_norms_plain(grads: torch.Tensor) -> torch.Tensor:
    """[P, L, D] -> [P, L] f32 squared norms."""
    g = grads.to(torch.float32)
    return (g * g).sum(dim=-1)


def fold_norms(grads: torch.Tensor) -> torch.Tensor:
    """Phase 1: per-(server, client) squared gradient norms, [P, L] f32."""
    check(grads, "grads", (None, None, None), FLOAT_TYPES)
    if not on_cuda(grads):
        return fold_norms_plain(grads)
    out = launch_norms(grads)
    _k.LAUNCHES["fold_norms"] += 1
    return out


def launch_norms(grads: torch.Tensor) -> torch.Tensor:
    """Launch the K1 kernel on a checked CUDA [P, L, D] tensor, without
    counting the launch: ``fold_norms`` counts its own, and ``clip_accum``
    runs it as its first pass under its own count."""
    P, L, D = grads.shape
    rows = P * L
    if rows > _MAX_GRID_Y:
        raise ValueError(f"fold_norms: P*L={rows} exceeds {_MAX_GRID_Y}")
    nsplit = -(-D // NORMS_CHUNK)
    out = torch.empty((P, L), dtype=torch.float32, device=grads.device)
    partial = torch.empty((rows, nsplit) if nsplit > 1 else (0,),
                          dtype=torch.float32, device=grads.device)
    fn = _build.function("fold_norms")
    _build.check(fn(grads.data_ptr(), int(grads.dtype == torch.bfloat16),
                    out.data_ptr(), partial.data_ptr(), rows, D, NORMS_CHUNK,
                    nsplit, stream_handle(grads)), "fold_norms")
    return out


def fold_apply_plain(w, grads, stepscale, fold_wn, noise_w, *, mode="none",
                     sigma=0.0, seeds=None, noise=None) -> torch.Tensor:
    """What the fold kernel computes, in torch: psi [P, D] in w.dtype."""
    g = grads.to(torch.float32)
    wb = w.to(torch.float32)
    if w.dim() == 2:
        wb = wb[:, None, :]
    upd = wb - stepscale.to(torch.float32)[..., None] * g
    acc = (fold_wn.to(torch.float32)[..., None] * upd).sum(dim=1)
    nw = noise_w.to(torch.float32)
    if mode == "laplace":
        acc = acc + (nw[..., None] * noise.to(torch.float32)).sum(dim=1)
    elif mode == "mask":
        acc = acc + hash_net_mask_fold(seeds, nw, g.shape[-1], sigma)
    return acc.to(w.dtype)


def _seeds_u32(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 seed values (held in any integer dtype) as int32 bit patterns,
    the layout the kernel reads as uint32."""
    s = seeds.to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def fold_apply(w: torch.Tensor, grads: torch.Tensor, stepscale: torch.Tensor,
               fold_wn: torch.Tensor, noise_w: torch.Tensor, *,
               mode: str = "none", sigma: float = 0.0,
               seeds: torch.Tensor | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2: fused scale/update/privatize/fold.

    w: [P, D] or [P, L, D]; grads: [P, L, D]; stepscale, fold_wn, noise_w:
    [P, L] f32.  Mode "mask" needs ``seeds`` [P] (uint32 values), mode
    "laplace" needs ``noise`` [P, L, D] in grads' dtype.  Returns psi
    [P, D] in w.dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown fold mode {mode!r}")
    check(grads, "grads", (None, None, None), FLOAT_TYPES)
    P, L, D = grads.shape
    per_client = w.dim() == 3
    check(w, "w", (P, L, D) if per_client else (P, D), FLOAT_TYPES)
    for name, t in (("stepscale", stepscale), ("fold_wn", fold_wn),
                    ("noise_w", noise_w)):
        check(t, name, (P, L), (torch.float32,))
    if mode == "mask":
        if seeds is None:
            raise ValueError("mask mode needs per-server seeds [P]")
        check(seeds, "seeds", (P,), (torch.int32, torch.int64))
    if mode == "laplace":
        if noise is None:
            raise ValueError("laplace mode needs pre-drawn noise [P, L, D]")
        check(noise, "noise", (P, L, D), (grads.dtype,))
    cuda = on_cuda(w, grads, stepscale, fold_wn, noise_w,
                   seeds if mode == "mask" else None,
                   noise if mode == "laplace" else None)
    if not cuda:
        return fold_apply_plain(w, grads, stepscale, fold_wn, noise_w,
                                mode=mode, sigma=sigma, seeds=seeds,
                                noise=noise)
    if P > _MAX_GRID_Y:
        raise ValueError(f"fold_apply: P={P} exceeds {_MAX_GRID_Y}")
    if D >= 2 ** 32:
        raise ValueError("fold_apply: the mask streams index D in uint32")
    out = torch.empty((P, D), dtype=w.dtype, device=w.device)
    seeds_u = _seeds_u32(seeds) if mode == "mask" else None
    fn = _build.function("fold_apply")
    _build.check(fn(w.data_ptr(), int(w.dtype == torch.bfloat16),
                    int(per_client), grads.data_ptr(),
                    int(grads.dtype == torch.bfloat16), stepscale.data_ptr(),
                    fold_wn.data_ptr(), noise_w.data_ptr(), MODES[mode],
                    float(sigma),
                    seeds_u.data_ptr() if seeds_u is not None else None,
                    noise.data_ptr() if mode == "laplace" else None,
                    out.data_ptr(), P, L, D, stream_handle(w)), "fold_apply")
    _k.LAUNCHES["fold_apply"] += 1
    return out
