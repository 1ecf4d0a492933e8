"""Privacy mechanisms for the GFL protocol (port of
``repro.core.privacy.mechanism``).

A :class:`PrivacyMechanism` owns both protocol hooks of a scheme

  client level (eq. 7):  ``client_protect(w_clients, draws, ctx) -> psi``
  server level (eq. 8):  ``server_combine(psi, draws, A, ctx) -> w``

plus :meth:`~PrivacyMechanism.fold_spec` (how the client level enters the
fused round-fold kernel) and a declarative ``noise_profile()`` for the
accountant.  The reference vmaps its hooks over servers; here the server
dimension is written out: ``w_clients`` is [P, L, D] and ``psi`` [P, D].
Randomness comes from the run's ``draws``
(:class:`~repro_torch.draws.Draws`), at the round ``ctx.step``, on the
``client`` and ``combine`` streams — where the reference splits its
per-server and combine keys.

Registered schemes: ``none``, ``iid_dp``, ``hybrid`` (the paper's three),
``gaussian_dp`` and ``scheduled[:inner]``.  With ``cfg.use_kernels`` the
engines route the client level through the fused round-fold kernel when
``fold_spec`` is not None, and every server level whose noise cancels
(``none`` and the hybrid family) through the fused graph-combine kernel;
``iid_dp``'s per-edge noise keeps the reference einsum.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.privacy.accountant import (
    PrivacyAccountant,
    scheduled_sigma_at,
)
from repro_torch.core.privacy.homomorphic import (
    combine_nonprivate,
    homomorphic_combine_noise,
    iid_noise_combine,
)
from repro_torch.core.privacy.noise import draw_noise
from repro_torch.core.privacy.secure_agg import num_pairs, pairwise_masks_vec
from repro_torch.kernels import ops as kops

DEFAULT_SCHEDULE_HORIZON = 100


@dataclass(frozen=True)
class NoiseProfile:
    """Declarative description of a mechanism's injected noise (the
    reference's fields, one for one)."""
    distribution: str              # "laplace" | "gaussian" | "none"
    client_sigma: float
    server_sigma: float
    client_cancels_exactly: bool
    server_cancels_exactly: bool
    curve: str = "laplace_thm2"    # accountant curve key
    delta: float = 1e-5            # gaussian curve only
    horizon: int = 0               # scheduled curve only
    epsilon_target: float = 0.0    # scheduled curve only
    client_dropout_safe: bool = False


class FoldSpec(NamedTuple):
    """How a mechanism's client level enters the fused round-fold kernel:
    ``mode`` is ``"none"``, ``"mask"`` or ``"laplace"``, ``sigma`` its
    scale."""
    mode: str
    sigma: float


@dataclass(frozen=True)
class RoundContext:
    """Per-round information threaded into the hooks: the round index
    ``step`` and an optional ``sigma`` override (``scheduled``).

    The reference runs its rounds inside ``jit``, where the step — and a
    scheduled sigma computed from it — is a traced value, and the fused
    fold (which needs a static scale) then falls back to the
    ``client_protect`` hook.  Eager torch always knows both, so the port
    carries the reference's view along: ``traced_step`` is set where the
    reference traces the step (its jitted step function), and
    ``sigma_traced`` where the sigma override derives from it."""
    step: Any = 0
    sigma: Any = None
    traced_step: bool = False
    sigma_traced: bool = False


class PrivacyMechanism:
    """Base class: the non-private protocol."""

    name = "none"

    def __init__(self, cfg):
        self.cfg = cfg

    def sigma(self, ctx: Optional[RoundContext] = None):
        """Noise std for this round (ctx.sigma overrides cfg.sigma_g)."""
        if ctx is not None and ctx.sigma is not None:
            return ctx.sigma
        return self.cfg.sigma_g

    def accountant(self) -> PrivacyAccountant:
        return PrivacyAccountant.from_profile(
            self.noise_profile(), self.cfg.mu, self.cfg.grad_bound)

    def client_protect(self, w_clients: torch.Tensor, draws,
                       ctx: RoundContext) -> torch.Tensor:
        """Aggregation step (7) for every server: [P, L, D] -> [P, D]."""
        return w_clients.mean(dim=1)

    def fold_spec(self, ctx: Optional[RoundContext] = None
                  ) -> Optional[FoldSpec]:
        """The client level as a fused-fold mode, or None when the engines
        must run :meth:`client_protect` instead."""
        return FoldSpec("none", 0.0)

    def server_combine(self, psi: torch.Tensor, draws, A: torch.Tensor,
                       ctx: RoundContext, *, cache=None, gate=None
                       ) -> torch.Tensor:
        """Combination step (8) across all servers: [P, D] -> [P, D]."""
        if self.cfg.use_kernels:
            return kops.graph_combine(A, psi, None, cache=cache, gate=gate)
        return combine_nonprivate(A, kops.apply_gate(psi, gate, cache))

    def noise_profile(self) -> NoiseProfile:
        return NoiseProfile(distribution="none", client_sigma=0.0,
                            server_sigma=0.0, client_cancels_exactly=True,
                            server_cancels_exactly=True, curve="none",
                            client_dropout_safe=True)


_REGISTRY: Dict[str, Callable[..., PrivacyMechanism]] = {}


def register_mechanism(name: str):
    """Class decorator registering a mechanism under `name`."""
    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"privacy mechanism {name!r} already registered")
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def list_mechanisms() -> list[str]:
    return sorted(_REGISTRY)


def get_mechanism(spec: str, cfg) -> PrivacyMechanism:
    """Instantiate ``"name"`` or ``"name:arg"`` for a GFLConfig."""
    name, _, arg = spec.partition(":")
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown privacy mechanism {name!r}; registered: "
            f"{list_mechanisms()}") from None
    return factory(cfg, arg) if arg else factory(cfg)


def mechanism_for(cfg) -> PrivacyMechanism:
    return get_mechanism(cfg.privacy, cfg)


@register_mechanism("none")
class NoPrivacy(PrivacyMechanism):
    """g == 0 everywhere — the non-private baseline."""


class _SecureAggClientMixin:
    """Client level of the hybrid family: pairwise Gaussian secure-agg
    masks that cancel exactly in the mean (eq. 23).  The reference path;
    under ``use_kernels`` the engines take :meth:`fold_spec` and the fold
    kernel's hash masks instead."""

    def client_protect(self, w_clients, draws, ctx):
        if not self.cfg.secure_agg:
            return w_clients.mean(dim=1)
        P, L, D = w_clients.shape
        normals = draws.normal(ctx.step, "client", (P, num_pairs(L), D))
        masks = pairwise_masks_vec(L, D, self.sigma(ctx), normals=normals,
                                   dtype=w_clients.dtype)
        return (w_clients + masks).mean(dim=1)

    def fold_spec(self, ctx=None):
        if not self.cfg.secure_agg:
            return FoldSpec("none", 0.0)
        if ctx is not None and ctx.sigma_traced:
            return None
        sigma = float(self.sigma(ctx))
        if sigma == 0.0:                 # zero-scale masks are exact zeros
            return FoldSpec("none", 0.0)
        return FoldSpec("mask", sigma)


class _HomomorphicServerMixin:
    """Server level of the hybrid family: graph-homomorphic noise in the
    nullspace of the averaging operator (eq. 24-25)."""

    distribution = "laplace"

    def server_combine(self, psi, draws, A, ctx, *, cache=None, gate=None):
        g = draw_noise(draws, ctx.step, "combine", self.distribution,
                       tuple(psi.shape), self.sigma(ctx), psi.dtype)
        if self.cfg.use_kernels:
            return kops.graph_combine(A, psi, g, cache=cache, gate=gate)
        return homomorphic_combine_noise(A, kops.apply_gate(psi, gate, cache),
                                         g)


@register_mechanism("hybrid")
class HybridMechanism(_SecureAggClientMixin, _HomomorphicServerMixin,
                      PrivacyMechanism):
    """The paper's scheme: secure-agg masks + graph-homomorphic Laplace."""

    def noise_profile(self):
        return NoiseProfile(distribution="laplace",
                            client_sigma=(self.cfg.sigma_g
                                          if self.cfg.secure_agg else 0.0),
                            server_sigma=self.cfg.sigma_g,
                            client_cancels_exactly=True,
                            server_cancels_exactly=True,
                            curve="laplace_thm2",
                            client_dropout_safe=True)


@register_mechanism("gaussian_dp")
class GaussianDPMechanism(_SecureAggClientMixin, _HomomorphicServerMixin,
                          PrivacyMechanism):
    """Graph-homomorphic GAUSSIAN noise (Gauthier et al. 2023)."""

    distribution = "gaussian"

    def noise_profile(self):
        return NoiseProfile(distribution="gaussian",
                            client_sigma=(self.cfg.sigma_g
                                          if self.cfg.secure_agg else 0.0),
                            server_sigma=self.cfg.sigma_g,
                            client_cancels_exactly=True,
                            server_cancels_exactly=True,
                            curve="gaussian",
                            client_dropout_safe=True)


@register_mechanism("iid_dp")
class IIDLaplaceDP(PrivacyMechanism):
    """The paper's baseline: independent Laplace at both levels."""

    def client_protect(self, w_clients, draws, ctx):
        # reference path; the fused fold (fold_spec "laplace") draws the
        # same noise from the same stream, so both backends see one noise
        # trajectory per seed
        noise = draw_noise(draws, ctx.step, "client", "laplace",
                           tuple(w_clients.shape), self.sigma(ctx),
                           w_clients.dtype)
        return (w_clients + noise).mean(dim=1)

    def fold_spec(self, ctx=None):
        if ctx is not None and ctx.sigma_traced:
            return None
        sigma = float(self.sigma(ctx))
        if sigma == 0.0:
            return FoldSpec("none", 0.0)
        return FoldSpec("laplace", sigma)

    def server_combine(self, psi, draws, A, ctx, *, cache=None, gate=None):
        P, D = psi.shape
        g = draw_noise(draws, ctx.step, "combine", "laplace", (P, P, D),
                       self.sigma(ctx), psi.dtype)
        return iid_noise_combine(A, kops.apply_gate(psi, gate, cache), g)

    def noise_profile(self):
        return NoiseProfile(distribution="laplace",
                            client_sigma=self.cfg.sigma_g,
                            server_sigma=self.cfg.sigma_g,
                            client_cancels_exactly=False,
                            server_cancels_exactly=False,
                            curve="laplace_thm2",
                            client_dropout_safe=True)


@register_mechanism("scheduled")
class ScheduledMechanism(PrivacyMechanism):
    """Accountant-driven noise schedule around any registered mechanism
    (``"scheduled"`` wraps ``hybrid``; ``"scheduled:<inner>"`` any other).
    With ``cfg.epsilon_target > 0`` round i's std is
    ``scheduled_sigma_at(i+1, ...)``; at 0 the wrapper is the identity."""

    def __init__(self, cfg, inner: str = "hybrid"):
        super().__init__(cfg)
        if inner.partition(":")[0] == "scheduled":
            raise ValueError("scheduled mechanism cannot wrap itself")
        self.inner = get_mechanism(inner, cfg)

    @property
    def horizon(self) -> int:
        return self.cfg.epsilon_horizon or DEFAULT_SCHEDULE_HORIZON

    def sigma_at(self, step):
        if self.cfg.epsilon_target <= 0:
            return self.cfg.sigma_g
        inner_prof = self.inner.noise_profile()
        return scheduled_sigma_at(step + 1, self.cfg.mu, self.cfg.grad_bound,
                                  self.horizon, self.cfg.epsilon_target,
                                  distribution=inner_prof.distribution,
                                  delta=inner_prof.delta)

    def _inner_ctx(self, ctx: Optional[RoundContext]) -> RoundContext:
        ctx = ctx if ctx is not None else RoundContext()
        # the reference's sigma_at is traced exactly when the schedule is on
        # and the step is traced
        return replace(ctx, sigma=self.sigma_at(ctx.step),
                       sigma_traced=(ctx.traced_step
                                     and self.cfg.epsilon_target > 0))

    def client_protect(self, w_clients, draws, ctx):
        return self.inner.client_protect(w_clients, draws,
                                         self._inner_ctx(ctx))

    def fold_spec(self, ctx=None):
        # a traced schedule makes the inner fold_spec return None, so the
        # client level runs the client_protect hook, as in the reference —
        # the same code path draws the same client-level randomness
        return self.inner.fold_spec(self._inner_ctx(ctx))

    def server_combine(self, psi, draws, A, ctx, *, cache=None, gate=None):
        return self.inner.server_combine(psi, draws, A, self._inner_ctx(ctx),
                                         cache=cache, gate=gate)

    def noise_profile(self):
        inner = self.inner.noise_profile()
        if self.cfg.epsilon_target <= 0 or inner.distribution == "none":
            return inner
        ref = type(self.inner)(replace(self.cfg, sigma_g=1.0)
                               ).noise_profile()
        sigma_h = float(self.sigma_at(self.horizon - 1))
        return replace(inner,
                       client_sigma=sigma_h if ref.client_sigma > 0 else 0.0,
                       server_sigma=sigma_h if ref.server_sigma > 0 else 0.0,
                       curve="scheduled", horizon=self.horizon,
                       epsilon_target=self.cfg.epsilon_target)
