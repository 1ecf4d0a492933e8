"""Resilient GFL execution: time-varying A_i, stragglers, client dropout
(port of ``repro.core.resilience.runtime``).

Per round the step

  1. realizes the round's topology ``A_i`` from the
     :class:`~repro_torch.core.resilience.process.TopologyProcess` on the
     host (deterministic in ``(topology_seed, round)``);
  2. applies mid-round client dropout: with ``cfg.use_kernels`` through the
     fused fold's survivor weights, else through the mechanism's
     ``client_protect_masked`` hook, after checking that the mechanism
     declares dropout safety (``noise_profile().client_dropout_safe``);
  3. lets straggling servers re-announce their most recent psi instead of
     the round's, for at most ``FaultModel.staleness`` rounds in a row (a
     server at the bound is made to refresh).

The round's A_i, survivor mask and straggler mask are written with
``copy_`` into buffers made once per (process, device)
(:func:`round_buffers`, :func:`stage_round`), so every round reads them at
the same addresses.  The step calls the static path's ``_client_updates``
and ``server_combine`` on the same draws, and each piece of fault
machinery runs only when its probability is nonzero, so a zero-probability
fault model gives a trajectory bitwise equal to the static path's.

:class:`StagedResilientStep` is the faulted round for the round graph: the
copies into the buffers are its host stage, before the replay, and the
straggler cache and ages are buffers of the step that the body updates in
place.  Realizing A_i stays on the host, as in the reference.
"""
from __future__ import annotations

import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core import gfl
from repro_torch.core.privacy.mechanism import RoundContext, mechanism_for
from repro_torch.core.resilience.process import TopologyProcess


class ResilientGFLState(NamedTuple):
    params: torch.Tensor     # [P, D] per-server flat models
    step: int                # rounds taken
    psi_cache: torch.Tensor  # [P, D] most recent psi each server announced
    psi_age: torch.Tensor    # [P] int32: consecutive rounds spent straggling


class RoundBuffers(NamedTuple):
    """One device's round inputs, overwritten in place every round."""
    A: torch.Tensor          # [P, P] f32 effective combination matrix
    alive: torch.Tensor      # [P, L] bool survivor mask
    straggler: torch.Tensor  # [P] bool straggler proposal


_BUFFERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def round_buffers(process: TopologyProcess, device, P: int,
                  L: int) -> RoundBuffers:
    """The process's round buffers on ``device`` (made once, remade only
    when L changes)."""
    per_device = _BUFFERS.setdefault(process, {})
    device = torch.device(device)
    buf = per_device.get(device)
    if buf is None or buf.alive.shape != (P, L):
        buf = per_device[device] = RoundBuffers(
            torch.empty((P, P), dtype=torch.float32, device=device),
            torch.ones((P, L), dtype=torch.bool, device=device),
            torch.zeros((P,), dtype=torch.bool, device=device))
    return buf


def stage_round(process: TopologyProcess, buf: RoundBuffers, i: int, *,
                dropout: bool, straggler: bool) -> None:
    """Realize round ``i`` on the host and copy A_i and, where their
    faults are on, the survivor and straggler masks into ``buf``: copies
    from pageable host memory, each synchronous, so they belong before a
    round, never inside one."""
    real = process.realize(i)
    buf.A.copy_(torch.from_numpy(real.A.astype(np.float32)))
    if dropout:
        buf.alive.copy_(torch.from_numpy(
            process.client_alive(i, buf.alive.shape[1])))
    if straggler:
        buf.straggler.copy_(torch.from_numpy(real.straggler))


def ensure_dropout_safe(profile, *, where: str = "client dropout") -> None:
    """Refuse to run client dropout through a mechanism that does not
    declare ``client_dropout_safe``: cancelling masks would leave orphaned
    streams in the aggregate, and client noise would fall back to the
    noise-free survivor mean, while the accountant keeps claiming a
    budget the released aggregate no longer pays for."""
    if not profile.client_dropout_safe:
        raise ValueError(
            f"{where}: mechanism does not declare client_dropout_safe — "
            "its client level is not guaranteed honest once a sampled "
            "client vanishes mid-round (orphaned secure-agg masks, or a "
            "noise-free fallback survivor mean).  Implement "
            "client_protect_masked for the scheme and declare "
            "client_dropout_safe=True in noise_profile(), or run fault "
            "specs without a dropout: component.")


def _fresh_age(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((params.shape[0],), dtype=torch.int32,
                       device=params.device)


def init_resilient_state(P: int, dim: int, init_scale: float = 0.0, *,
                         generator=None, device=None) -> ResilientGFLState:
    """:func:`repro_torch.core.gfl.init_state`, plus the straggler psi
    cache seeded with the initial params."""
    base = gfl.init_state(P, dim, init_scale, generator=generator,
                          device=device)
    return ResilientGFLState(base.params, base.step, psi_cache=base.params,
                             psi_age=_fresh_age(base.params))


def make_resilient_gfl_step(process: TopologyProcess, grad_fn: Callable,
                            cfg: GFLConfig) -> Callable:
    """(state, batch, draws) -> state under the process's fault model.

    Accepts a :class:`ResilientGFLState` or a plain
    :class:`~repro_torch.core.gfl.GFLState` (promoted on first use).  The
    rounds run with ``traced_step=True``, as the reference's jitted step."""
    mech = mechanism_for(cfg)
    fault = process.fault
    use_dropout = fault.client_dropout > 0
    use_straggler = fault.straggler > 0
    if use_dropout:
        ensure_dropout_safe(mech.noise_profile())

    def step(state, batch, draws) -> ResilientGFLState:
        if not isinstance(state, ResilientGFLState):
            state = ResilientGFLState(state.params, state.step,
                                      psi_cache=state.params,
                                      psi_age=_fresh_age(state.params))
        i = int(state.step)
        buf = round_buffers(process, state.params.device,
                            state.params.shape[0], batch[0].shape[1])
        stage_round(process, buf, i, dropout=use_dropout,
                    straggler=use_straggler)
        ctx = RoundContext(step=i, traced_step=True)
        # the static path's (6)+(7): bitwise equal under a null fault model
        psi = gfl._client_updates(state.params, batch, draws, grad_fn, cfg,
                                  mech, ctx,
                                  buf.alive if use_dropout else None)
        if use_straggler:
            psi, new_age = _straggle(buf, psi, state.psi_cache,
                                     state.psi_age, fault.staleness)
            new_cache = psi
        else:
            new_cache, new_age = state.psi_cache, state.psi_age
        new_params = (mech.server_combine(psi, draws, buf.A, ctx)
                      if gfl.combines(cfg, i) else psi)
        return ResilientGFLState(new_params, i + 1, new_cache, new_age)

    return step


def _straggle(buf: RoundBuffers, psi, cache, age, staleness: int):
    """Bounded staleness: a server may straggle only while its cached psi
    is younger than the bound.  Returns (announced psi, new ages)."""
    stale_ok = buf.straggler & (age < staleness)
    return (torch.where(stale_ok[:, None], cache, psi),
            torch.where(stale_ok, age + 1, 0))


class StagedResilientStep(gfl.StagedStep):
    """:func:`make_resilient_gfl_step` split for the round graph: the host
    stage realizes A_i and copies it and the masks into the process's
    round buffers; the body reads them there and keeps the straggler
    cache ``psi_cache`` and ages ``psi_age`` in buffers of its own."""

    def __init__(self, process: TopologyProcess, grad_fn: Callable,
                 cfg: GFLConfig, P: int, dim: int, L: int, iters: int,
                 device):
        super().__init__(process.base_A, grad_fn, cfg, P, dim, iters, device)
        self.process = process
        self.dropout = process.fault.client_dropout > 0
        self.straggler = process.fault.straggler > 0
        if self.dropout:
            ensure_dropout_safe(self.mech.noise_profile())
        self.buf = round_buffers(process, self.params.device, P, L)
        self.A = self.buf.A
        self.psi_cache = self.params.clone()
        self.psi_age = _fresh_age(self.params)

    def stage(self, i: int, draws) -> bool:
        stage_round(self.process, self.buf, i, dropout=self.dropout,
                    straggler=self.straggler)
        return super().stage(i, draws)

    def body(self, batch, draws, i: int, combine: bool) -> None:
        ctx = self.context(i)
        psi = gfl._client_updates(self.params, batch, draws, self.grad_fn,
                                  self.cfg, self.mech, ctx,
                                  self.buf.alive if self.dropout else None)
        if self.straggler:
            psi, age = _straggle(self.buf, psi, self.psi_cache, self.psi_age,
                                 self.process.fault.staleness)
            self.psi_age.copy_(age)
            self.psi_cache.copy_(psi)
        self.params.copy_(self.mech.server_combine(psi, draws, self.A, ctx)
                          if combine else psi)
