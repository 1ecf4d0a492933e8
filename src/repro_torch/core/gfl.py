"""The Graph Federated Learning protocol (eqs. 6-8) over flat parameter
vectors — port of ``repro.core.gfl``.

One round:
  (6) client update:      w_{p,k} = w_p - mu * clip_B(grad Q(w_p; batch_{p,k}))
  (7) server aggregation: psi_p   = (1/L) sum_k (w_{p,k} + g_{p,k})
  (8) server combination: w_p     = sum_m a_mp (psi_m + g_{mp})

Both noise insertions belong to the configured
:class:`~repro_torch.core.privacy.mechanism.PrivacyMechanism`; this module
never branches on the scheme name.  With ``cfg.use_kernels`` the client
level runs as the fused round fold (``kernels.ops.round_fold``: the
``fold_norms`` and ``fold_apply`` kernels) whenever the mechanism declares
a ``fold_spec``, and the combine as the ``graph_combine`` kernel.

The reference vmaps over servers and clients; here those dimensions are
written out ([P, L, D] gradients).  Randomness comes from the run's
``draws`` (:mod:`repro_torch.draws`) instead of a key in the state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core.privacy.mechanism import (
    PrivacyMechanism,
    RoundContext,
    mechanism_for,
)
from repro_torch.core.privacy.noise import draw_noise
from repro_torch.kernels import ops as kops

_NEXT_SLICE = ("is not ported yet: fault processes come with the resilience "
               "slice (ROADMAP slice 2)")


class GFLState(NamedTuple):
    params: torch.Tensor   # [P, D] per-server flat models
    step: int              # rounds taken


def clip_to_bound(g: torch.Tensor, bound: float) -> torch.Tensor:
    """Project each gradient (last dim) onto the B-ball (eq. 14)."""
    if bound <= 0:
        return g
    nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)


def _client_grads(params: torch.Tensor, batch, grad_fn) -> torch.Tensor:
    """Raw per-client gradients [P, L, D] (the fused kernel's input)."""
    return grad_fn(params, batch)


def _survivor_weights(alive):
    """(fold_w, noise_w) for a [P, L] participation mask: survivors fold
    uniformly and the noise/mask term enters at the survivor mean.  None ->
    (None, None), the all-alive uniform fold."""
    if alive is None:
        return None, None
    af = alive.to(torch.float32)
    return af, af / torch.clamp(af.sum(dim=1, keepdim=True), min=1.0)


def _fused_client_fold(w, grads, draws, cfg: GFLConfig, mech, ctx, *,
                       pre_w=None, fold_w=None, noise_w=None):
    """(6)+(7) through the fused round-fold kernels, or None when the fused
    path does not apply (``use_kernels`` off, or no ``fold_spec``).
    Returns (psi [P, D], sq [P, L] raw squared gradient norms)."""
    if not cfg.use_kernels:
        return None
    spec = mech.fold_spec(ctx)
    if spec is None:
        return None
    P, L, D = grads.shape
    seeds = noise = None
    if spec.mode == "mask":
        seeds = draws.mask_seeds(ctx.step, P)
    elif spec.mode == "laplace":
        # the reference sampler's draw on the client stream: the same
        # noise the client_protect path would add
        noise = draw_noise(draws, ctx.step, "client", "laplace", (P, L, D),
                           spec.sigma, grads.dtype)
    return kops.round_fold(w, grads, mu=cfg.mu, bound=cfg.grad_bound,
                           pre_w=pre_w, fold_w=fold_w, noise_w=noise_w,
                           mode=spec.mode, sigma=spec.sigma, seeds=seeds,
                           noise=noise)


def _client_updates(params, batch, draws, grad_fn, cfg, mech, ctx,
                    alive=None):
    """(6)+(7): per-server client updates and protected aggregation."""
    if alive is not None:
        raise NotImplementedError(
            "client dropout (the masked aggregation hook) " + _NEXT_SLICE)
    grads = _client_grads(params, batch, grad_fn)
    fused = _fused_client_fold(params, grads, draws, cfg, mech, ctx)
    if fused is not None:
        return fused[0]
    updates = params[:, None, :] - cfg.mu * clip_to_bound(grads,
                                                          cfg.grad_bound)
    return mech.client_protect(updates, draws, ctx)


def _check_static(A) -> None:
    if not isinstance(A, (torch.Tensor, np.ndarray)):
        raise NotImplementedError(
            f"combination process {type(A).__name__} " + _NEXT_SLICE)


def gfl_round(params: torch.Tensor, batch, draws, *, A, grad_fn: Callable,
              cfg: GFLConfig, mechanism: Optional[PrivacyMechanism] = None,
              step: int = 0, traced_step: bool = False) -> torch.Tensor:
    """One full GFL round.

    params: [P, D]; batch: (h [P, L, B, M], gamma [P, L, B]);
    grad_fn(params, batch) -> [P, L, D].  ``A`` is the fixed [P, P]
    combination matrix.  ``traced_step`` says the reference would run this
    round with a traced step (see :class:`RoundContext`)."""
    _check_static(A)
    if cfg.fault != "none":
        raise NotImplementedError(f"fault={cfg.fault!r} " + _NEXT_SLICE)
    mech = mechanism if mechanism is not None else mechanism_for(cfg)
    A = torch.as_tensor(A, dtype=torch.float32, device=params.device)
    ctx = RoundContext(step=step, traced_step=traced_step)
    psi = _client_updates(params, batch, draws, grad_fn, cfg, mech, ctx)
    return mech.server_combine(psi, draws, A, ctx)


def make_gfl_step(A, grad_fn: Callable, cfg: GFLConfig):
    """(state, batch, draws) -> state transition.

    ``combine_every=tau > 1`` combines only every tau-th round; the other
    rounds never call the mechanism's server level, so they add no combine
    noise (the client level still runs).  The reference jits this step, so
    its rounds see a traced step (``traced_step=True``)."""
    _check_static(A)
    if cfg.fault != "none":
        raise NotImplementedError(f"fault={cfg.fault!r} " + _NEXT_SLICE)
    A_host = torch.as_tensor(np.asarray(A), dtype=torch.float32)
    mech = mechanism_for(cfg)
    on_device = {}

    def step(state: GFLState, batch, draws) -> GFLState:
        dev = state.params.device
        if dev not in on_device:
            on_device[dev] = A_host.to(dev)
        A_d = on_device[dev]
        if cfg.combine_every > 1:
            do_combine = (state.step % cfg.combine_every
                          == cfg.combine_every - 1)
            ctx = RoundContext(step=state.step, traced_step=True)
            psi = _client_updates(state.params, batch, draws, grad_fn, cfg,
                                  mech, ctx)
            new_params = (mech.server_combine(psi, draws, A_d, ctx)
                          if do_combine else psi)
        else:
            new_params = gfl_round(state.params, batch, draws, A=A_d,
                                   grad_fn=grad_fn, cfg=cfg, mechanism=mech,
                                   step=state.step, traced_step=True)
        return GFLState(new_params, state.step + 1)

    return step


def init_state(P: int, dim: int, init_scale: float = 0.0, *,
               generator: Optional[torch.Generator] = None,
               device=None) -> GFLState:
    """Zeros at ``init_scale=0`` (the reference's default, which makes its
    initial state independent of the key); else scaled normals."""
    if init_scale == 0.0:
        params = torch.zeros((P, dim), dtype=torch.float32, device=device)
    else:
        if generator is None:
            raise ValueError("a random initial state needs a generator")
        params = init_scale * torch.randn((P, dim), generator=generator,
                                          device=generator.device)
    return GFLState(params, 0)


def centroid(params: torch.Tensor) -> torch.Tensor:
    """Network centroid w_c = (1/P) sum_p w_p (eq. 15)."""
    return params.mean(dim=0)
