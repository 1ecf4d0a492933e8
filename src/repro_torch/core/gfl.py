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

``A`` may also be a :class:`~repro_torch.core.resilience.process.
TopologyProcess`: the round then runs under its fault model (per-round
A_i, client dropout; stragglers in the step function, which dispatches to
:mod:`repro_torch.core.resilience.runtime`).

:func:`make_gfl_step` is the eager step.  :class:`StagedStep` is the same
round split for the round graph (:mod:`repro_torch.core.population.
graphed`): a host stage that knows the round index, and a device body
that reads only buffers made once a run, so a CUDA graph of the body
replays every round.
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


class GFLState(NamedTuple):
    params: torch.Tensor   # [P, D] per-server flat models
    step: int              # rounds taken


def clip_to_bound(g: torch.Tensor, bound: float) -> torch.Tensor:
    """Project each gradient (last dim) onto the B-ball (eq. 14)."""
    if bound <= 0:
        return g
    nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(bound / torch.clamp(nrm, min=1e-12), max=1.0)


def server_aggregate(w_clients: torch.Tensor, draws, cfg: GFLConfig,
                     mechanism: Optional[PrivacyMechanism] = None,
                     ctx: Optional[RoundContext] = None) -> torch.Tensor:
    """Aggregation step (7) for every server: w_clients [P, L, D] -> psi
    [P, D] (the reference's takes one server's [L, D] under a vmap)."""
    mech = mechanism if mechanism is not None else mechanism_for(cfg)
    # a single-round primitive: a caller composing rounds owns the
    # accountant (the engines charge theirs)
    return mech.client_protect(  # gflint: disable=GFL002
        w_clients, draws, ctx if ctx is not None else RoundContext())


def server_combine(psi: torch.Tensor, draws, A: torch.Tensor,
                   cfg: GFLConfig,
                   mechanism: Optional[PrivacyMechanism] = None,
                   ctx: Optional[RoundContext] = None) -> torch.Tensor:
    """Combination step (8) across all servers: psi [P, D] -> [P, D]."""
    mech = mechanism if mechanism is not None else mechanism_for(cfg)
    return mech.server_combine(psi, draws, A,
                               ctx if ctx is not None else RoundContext())


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
    """(6)+(7): per-server client updates and protected aggregation.

    ``alive`` ([P, L] bool, optional) marks the clients that survived the
    round: the fused fold then weights survivors (``_survivor_weights``),
    and the unfused path takes the mechanism's dropout-safe
    ``client_protect_masked`` hook."""
    grads = _client_grads(params, batch, grad_fn)
    fold_w, noise_w = _survivor_weights(alive)
    fused = _fused_client_fold(params, grads, draws, cfg, mech, ctx,
                               fold_w=fold_w, noise_w=noise_w)
    if fused is not None:
        return fused[0]
    updates = params[:, None, :] - cfg.mu * clip_to_bound(grads,
                                                          cfg.grad_bound)
    if alive is None:
        return mech.client_protect(updates, draws, ctx)
    return mech.client_protect_masked(updates, draws, alive, ctx)


def gfl_round(params: torch.Tensor, batch, draws, *, A, grad_fn: Callable,
              cfg: GFLConfig, mechanism: Optional[PrivacyMechanism] = None,
              step: int = 0, traced_step: bool = False) -> torch.Tensor:
    """One full GFL round.

    params: [P, D]; batch: (h [P, L, B, M], gamma [P, L, B]);
    grad_fn(params, batch) -> [P, L, D].  ``A`` is the fixed [P, P]
    combination matrix, or a :class:`TopologyProcess` whose round-``step``
    realization (A_i and, with a dropout component, the survivor mask)
    this round runs under; stragglers keep state across rounds and live
    only in the step functions.  ``traced_step`` says the reference would
    run this round with a traced step (see :class:`RoundContext`)."""
    # imported here, as the reference does: resilience imports this module
    from repro_torch.core.resilience.process import TopologyProcess

    mech = mechanism if mechanism is not None else mechanism_for(cfg)
    alive = None
    if isinstance(A, TopologyProcess):
        from repro_torch.core.resilience.runtime import (
            ensure_dropout_safe, round_buffers, stage_round)
        proc = A
        dropout = proc.fault.client_dropout > 0
        if dropout:
            ensure_dropout_safe(mech.noise_profile())
        buf = round_buffers(proc, params.device, params.shape[0],
                            batch[0].shape[1])
        stage_round(proc, buf, int(step), dropout=dropout, straggler=False)
        A, alive = buf.A, (buf.alive if dropout else None)
    A = torch.as_tensor(A, dtype=torch.float32, device=params.device)
    ctx = RoundContext(step=step, traced_step=traced_step)
    psi = _client_updates(params, batch, draws, grad_fn, cfg, mech, ctx,
                          alive)
    return mech.server_combine(psi, draws, A, ctx)


def make_gfl_step(A, grad_fn: Callable, cfg: GFLConfig):
    """(state, batch, draws) -> state transition.

    ``combine_every=tau > 1`` combines only every tau-th round; the other
    rounds never call the mechanism's server level, so they add no combine
    noise (the client level still runs).  The reference jits this step, so
    its rounds see a traced step (``traced_step=True``).  A
    :class:`TopologyProcess` for ``A`` dispatches to the resilience runtime
    (per-round A_i, client dropout, stragglers)."""
    from repro_torch.core.resilience.process import TopologyProcess

    if isinstance(A, TopologyProcess):
        from repro_torch.core.resilience.runtime import (
            make_resilient_gfl_step)
        return make_resilient_gfl_step(A, grad_fn, cfg)
    A_host = torch.as_tensor(np.asarray(A), dtype=torch.float32)
    mech = mechanism_for(cfg)
    on_device = {}

    def step(state: GFLState, batch, draws) -> GFLState:
        dev = state.params.device
        if dev not in on_device:
            on_device[dev] = A_host.to(dev)
        A_d = on_device[dev]
        if cfg.combine_every > 1:
            ctx = RoundContext(step=state.step, traced_step=True)
            psi = _client_updates(state.params, batch, draws, grad_fn, cfg,
                                  mech, ctx)
            new_params = (mech.server_combine(psi, draws, A_d, ctx)
                          if combines(cfg, state.step) else psi)
        else:
            new_params = gfl_round(state.params, batch, draws, A=A_d,
                                   grad_fn=grad_fn, cfg=cfg, mechanism=mech,
                                   step=state.step, traced_step=True)
        return GFLState(new_params, state.step + 1)

    return step


def combines(cfg: GFLConfig, i: int) -> bool:
    """Whether round ``i`` runs the server combination (``combine_every``;
    the reference's ``lax.cond``)."""
    tau = cfg.combine_every
    return tau <= 1 or i % tau == tau - 1


_UNSEEN = object()


class StagedStep:
    """The step of :func:`make_gfl_step` split for the round graph.

    :meth:`stage` runs on the host and knows the round index: it reseeds
    the run's draws for the round, checks that the fused fold's by-value
    sigma is the run's (K2 takes it as an argument, so a graph bakes it
    in), and returns whether the round combines, which picks the graph.
    :meth:`body` runs on the device and reads only buffers made here once
    a run: ``params``, the round ``counter``, the sigma table, ``A``.  It
    writes the new params into ``params``; the executor advances the
    counter.  Run eagerly (stage, then body) it is bitwise the eager
    step.  With a telemetry session the engine sets ``norms_tap`` (a
    :class:`~repro_torch.telemetry.MetricsStream`) and the body writes the
    round's update and param norms into it; without one the body has no
    extra op."""

    psi_age = None       # [P] int32 straggler ages (the resilient step)
    norms_tap = None     # MetricsStream of the step stream, when observed

    def __init__(self, A, grad_fn: Callable, cfg: GFLConfig, P: int,
                 dim: int, iters: int, device):
        self.cfg, self.grad_fn = cfg, grad_fn
        self.mech = mechanism_for(cfg)
        self.params = init_state(P, dim, device=device).params
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.A = torch.as_tensor(np.asarray(A), dtype=torch.float32
                                 ).to(device)
        self.sigmas = self.mech.sigma_table(iters, device)
        self._fold = _UNSEEN

    def stage(self, i: int, draws) -> bool:
        """Host stage of round ``i``; returns whether it combines."""
        draws.stage(i)
        if self.cfg.use_kernels:
            spec = self.mech.fold_spec(RoundContext(step=i, traced_step=True))
            if self._fold is _UNSEEN:
                self._fold = spec
            elif spec != self._fold:
                raise RuntimeError(
                    f"round {i}: fold spec {spec} differs from the run's "
                    f"{self._fold}, which the round graph holds by value")
        return combines(self.cfg, i)

    def context(self, i: int) -> RoundContext:
        """The round's context: a scheduled sigma is the table's entry at
        the device counter, never a host value."""
        sigma = None
        if self.sigmas is not None:
            sigma = torch.index_select(self.sigmas, 0, self.counter
                                       ).reshape(())
        return RoundContext(step=i, sigma=sigma, traced_step=True)

    def body(self, batch, draws, i: int, combine: bool) -> None:
        ctx = self.context(i)
        psi = _client_updates(self.params, batch, draws, self.grad_fn,
                              self.cfg, self.mech, ctx)
        new = (self.mech.server_combine(psi, draws, self.A, ctx)
               if combine else psi)
        if self.norms_tap is not None:
            tap_step_norms(self.norms_tap, self.counter, new, self.params)
        self.params.copy_(new)


def tap_step_norms(tap, at, new: torch.Tensor, old: torch.Tensor) -> None:
    """The ``step`` stream's read-only tap (the reference's jitted step
    emits it): ||new - old|| and ||new|| into ``tap``'s row ``at``."""
    tap.tap(at, {"update_norm": torch.linalg.vector_norm(new - old),
                 "param_norm": torch.linalg.vector_norm(new)})


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
