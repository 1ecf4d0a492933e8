"""Differential-privacy accounting for the GFL algorithm (Theorem 2).

Sensitivity (eq. 26):  Delta(i) <= 2 mu B i
Theorem 2:  the hybrid scheme is eps(i)-DP at iteration i when

    sigma_g = sqrt(2) * mu * B * (1 + i) * i / eps(i)

Equivalently, for a fixed sigma_g, privacy decays quadratically:

    eps(i) = sqrt(2) * mu * B * (1 + i) * i / sigma_g = O(i^2).

Beyond the paper's Laplace curve this module carries two more curves,
selected by a :class:`PrivacyMechanism`'s ``noise_profile().curve``:

``gaussian``
    (eps, delta)-DP of the Gaussian mechanism (Gauthier et al. 2023
    variant) under basic composition: the sqrt(2) Laplace constant becomes
    ``sqrt(2 ln(1.25/delta))``.

``scheduled``
    Per-step noise schedule spending a uniform ``eps_target / horizon``
    budget each iteration, so the composed epsilon is *linear* in i and
    hits ``eps_target`` exactly at the horizon (instead of Theorem 2's
    quadratic blow-up).  ``scheduled_sigma_at`` is traced-value safe and is
    what the ``scheduled`` mechanism evaluates inside jit.

Every curve additionally exposes an **amplification-by-subsampling**
variant (arXiv:2301.06412 accounting for the partial-participation regime
of arXiv:2203.07105): when round j samples each client with probability
q_j — the ``CohortScheduler``'s realized rate L/K — release j is charged
``ln(1 + q_j (e^{eps_j} - 1))`` instead of its full-participation eps_j
(and deltas scale to ``q_j * delta``).  ``advance(steps, q=...)`` records
realized rates; ``amplified_epsilon()`` / ``amplified_delta()`` read the
amplified ledger, and q = 1 reproduces the unamplified curve exactly.

Carried over from the reference's pure-python module unchanged in its
arithmetic (the tests hold every curve exactly equal), with the per-server
ledger of the event engine (:class:`AsyncAccountant`); the telemetry emit
comes with a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def sensitivity(i, mu: float, B: float):
    """Delta(i) <= 2 mu B i (eq. 26)."""
    return 2.0 * mu * B * i


def epsilon_at(i: int, mu: float, B: float, sigma_g: float) -> float:
    """eps(i) for fixed noise std sigma_g (Theorem 2, rearranged)."""
    if sigma_g <= 0:
        return float("inf")
    return (2.0 ** 0.5) * mu * B * (1 + i) * i / sigma_g


def sigma_for_epsilon(i: int, mu: float, B: float, eps: float) -> float:
    """Noise std needed for eps(i)-DP at horizon i (Theorem 2)."""
    if eps <= 0:
        raise ValueError("epsilon must be positive")
    return (2.0 ** 0.5) * mu * B * (1 + i) * i / eps


# --------------------------------------------------------- Gaussian curve --


def _gaussian_const(delta: float) -> float:
    """sqrt(2 ln(1.25/delta)) — the Gaussian-mechanism analogue of the
    Laplace sqrt(2)."""
    if not 0 < delta < 1:
        raise ValueError("delta must be in (0, 1)")
    return math.sqrt(2.0 * math.log(1.25 / delta))


def gaussian_epsilon_at(i: int, mu: float, B: float, sigma_g: float,
                        delta: float = 1e-5) -> float:
    """Epsilon of the Gaussian scheme at iteration i, basic composition
    over the per-iteration releases (sensitivity eq. 26).

    ``delta`` is the PER-RELEASE delta; under basic composition the deltas
    add, so the composed guarantee after i releases is
    ``(returned epsilon, i * delta)``-DP — see
    :meth:`PrivacyAccountant.delta_spent`.
    """
    if sigma_g <= 0:
        return float("inf")
    return _gaussian_const(delta) * mu * B * (1 + i) * i / sigma_g


def gaussian_sigma_for_epsilon(i: int, mu: float, B: float, eps: float,
                               delta: float = 1e-5) -> float:
    """Gaussian noise std for (eps, delta)-DP at horizon i."""
    if eps <= 0:
        raise ValueError("epsilon must be positive")
    return _gaussian_const(delta) * mu * B * (1 + i) * i / eps


# -------------------------------------------------------- scheduled curve --


def per_release_constant(distribution: str = "laplace",
                         delta: float = 1e-5) -> float:
    """sigma = const * Delta / eps for one release of the given additive
    noise: sqrt(2) for Laplace (pure eps-DP), sqrt(2 ln(1.25/delta)) for
    Gaussian ((eps, delta)-DP)."""
    return (_gaussian_const(delta) if distribution == "gaussian"
            else 2.0 ** 0.5)


def scheduled_sigma_at(i, mu: float, B: float, horizon: int,
                       eps_target: float, distribution: str = "laplace",
                       delta: float = 1e-5):
    """Per-step noise std of the uniform-budget schedule.

    Step i releases a message of sensitivity Delta(i) = 2 mu B i and is
    granted eps_i = eps_target / horizon, so

        sigma_i = const(distribution) * Delta(i) * horizon / eps_target

    with the per-release constant of the wrapped noise distribution.
    Pure arithmetic in ``i`` — safe to call with a traced jax scalar.
    """
    if eps_target <= 0:
        raise ValueError("epsilon target must be positive")
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    return (per_release_constant(distribution, delta)
            * sensitivity(i, mu, B) * horizon / eps_target)


def scheduled_epsilon_spent(i: int, horizon: int, eps_target: float) -> float:
    """Composed epsilon after i steps of the uniform-budget schedule:
    linear consumption, equal to eps_target exactly at i == horizon (and
    still growing linearly past it — running longer keeps spending)."""
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    return eps_target * i / horizon


# ---------------------------------------------- subsampling amplification --


def amplified_release_epsilon(eps: float, q: float) -> float:
    """Privacy amplification by subsampling for ONE release.

    A mechanism that is eps-DP on the full population is
    ``ln(1 + q (e^eps - 1))``-DP when each client participates with
    probability q (and a delta, if any, scales to q * delta) — the
    partial-participation accounting of arXiv:2301.06412 / the classic
    subsampling lemma.  q = 1 returns eps exactly; q -> 0 approaches
    q * eps (the small-budget linear regime).
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling rate q={q} not in (0, 1]")
    if q == 1.0 or math.isinf(eps):
        return eps
    if eps <= 30.0:
        return math.log1p(q * math.expm1(eps))
    # large eps: rewrite as ln(e^{ln q + eps} + (1 - q)) so nothing
    # overflows and a tiny q cannot drive the result negative (q e^eps
    # may still be < 1 there — the naive eps + ln q shortcut is wrong
    # until q e^eps dominates)
    x = math.log(q) + eps
    if x > 700.0:            # e^x would overflow float64; (1-q) vanishes
        return x
    return math.log1p(math.exp(x) - q)


_CURVES = ("laplace_thm2", "gaussian", "scheduled", "none")


@dataclass
class PrivacyAccountant:
    """Tracks the epsilon ledger of a running GFL job.

    ``curve`` selects the accountant model; the default reproduces the
    paper's Theorem-2 Laplace analysis.  Build one for a registered
    mechanism with :meth:`from_profile` (consumes
    ``PrivacyMechanism.noise_profile()``).
    """
    mu: float
    grad_bound: float
    sigma_g: float
    step: int = 0
    history: list = field(default_factory=list)
    curve: str = "laplace_thm2"
    delta: float = 1e-5
    horizon: int = 0
    epsilon_target: float = 0.0
    distribution: str = "laplace"
    sampling_rate: float = 1.0     # default per-round cohort rate q = L/K
    q_history: list = field(default_factory=list)  # realized q per release
    owner: str = ""                # ledger tag in telemetry records ("" =
                                   # the scalar ledger; AsyncAccountant tags
                                   # its per-server ledgers "server<p>")

    def __post_init__(self):
        if self.curve not in _CURVES:
            raise ValueError(f"unknown accountant curve {self.curve!r}; "
                             f"expected one of {_CURVES}")

    @classmethod
    def from_profile(cls, profile, mu: float, grad_bound: float
                     ) -> "PrivacyAccountant":
        """Accountant configured from a mechanism's NoiseProfile."""
        return cls(mu=mu, grad_bound=grad_bound,
                   sigma_g=profile.server_sigma, curve=profile.curve,
                   delta=profile.delta, horizon=profile.horizon,
                   epsilon_target=profile.epsilon_target,
                   distribution=profile.distribution)

    def advance(self, steps: int = 1, q: float | None = None) -> float:
        """Advance the ledger by `steps` releases.

        ``q`` records the realized cohort sampling rate of those releases
        (defaults to the accountant's ``sampling_rate``).  Pass the rate
        the rounds ACTUALLY ran at — per round, ``CohortSelection.q`` —
        not a running mean over rounds with different rates: the
        amplification bound is per release, and averaging a varying q
        before recording under-reports the spend.  The returned epsilon is
        the UNAMPLIFIED curve (the paper's full-participation ledger);
        :meth:`amplified_epsilon` reads the amplified one.
        """
        self.q_history.extend([self.sampling_rate if q is None else q]
                              * steps)
        self.step += steps
        eps = self.epsilon()
        self.history.append((self.step, eps))
        from repro_torch.telemetry.stream import emit, telemetry_active
        if telemetry_active():
            q_rel = self.q_history[-1] if self.q_history \
                else self.sampling_rate
            eps_rel = self.per_release_epsilon(self.step)
            emit("privacy", {
                "step": self.step, "eps": eps, "eps_release": eps_rel,
                "eps_release_amp": (
                    amplified_release_epsilon(eps_rel, q_rel)
                    if 0.0 < q_rel <= 1.0 else eps_rel),
                "delta": self.delta_spent(), "q": q_rel,
                "curve": self.curve, "server": self.owner})
        return eps

    def epsilon(self) -> float:
        if self.curve == "none":
            return 0.0
        if self.curve == "gaussian":
            return gaussian_epsilon_at(self.step, self.mu, self.grad_bound,
                                       self.sigma_g, self.delta)
        if self.curve == "scheduled":
            return scheduled_epsilon_spent(self.step, self.horizon,
                                           self.epsilon_target)
        return epsilon_at(self.step, self.mu, self.grad_bound, self.sigma_g)

    def per_release_epsilon(self, j: int) -> float:
        """Epsilon of release j alone (1-indexed), i.e. the increment the
        composed curve charges at step j: the Theorem-2 Laplace/Gaussian
        curves satisfy eps(i) = sum_{j<=i} c * 2 mu B j / sigma, and the
        scheduled curve spends a uniform eps_target / horizon slice."""
        if self.curve == "none":
            return 0.0
        if self.curve == "scheduled":
            if self.horizon <= 0:
                raise ValueError("scheduled curve needs a positive horizon")
            return self.epsilon_target / self.horizon
        if self.sigma_g <= 0:
            return float("inf")
        const = (_gaussian_const(self.delta) if self.curve == "gaussian"
                 else 2.0 ** 0.5)
        return const * 2.0 * self.mu * self.grad_bound * j / self.sigma_g

    def _release_qs(self) -> list:
        """Realized per-release sampling rates, padded with the default."""
        qs = list(self.q_history[:self.step])
        qs += [self.sampling_rate] * (self.step - len(qs))
        return qs

    def amplified_epsilon(self, q: float | None = None) -> float:
        """Composed epsilon under amplification by subsampling.

        Each release j is charged ``ln(1 + q_j (e^{eps_j} - 1))`` instead
        of eps_j, where q_j is the realized cohort sampling rate recorded
        by :meth:`advance` (override every q_j with the ``q`` argument).
        q = 1 reproduces :meth:`epsilon` exactly — unit-pinned in
        tests/test_privacy.py.
        """
        if self.curve == "none":
            return 0.0
        qs = [q] * self.step if q is not None else self._release_qs()
        return sum(amplified_release_epsilon(self.per_release_epsilon(j), qj)
                   for j, qj in enumerate(qs, start=1))

    def amplified_delta(self, q: float | None = None) -> float:
        """Composed delta under subsampling: each release's delta scales by
        its q before the basic-composition sum."""
        if self.distribution != "gaussian":
            return 0.0
        qs = [q] * self.step if q is not None else self._release_qs()
        return self.delta * sum(qs)

    def amplification_curve(self, steps: int, q: float) -> list:
        """Prospective amplified-epsilon trajectory [(i, eps_amp(i))] for a
        fixed sampling rate q — does not mutate the ledger."""
        out, total = [], 0.0
        for j in range(1, steps + 1):
            total += amplified_release_epsilon(self.per_release_epsilon(j), q)
            out.append((j, total))
        return out

    def delta_spent(self) -> float:
        """Composed delta after `step` releases: the per-release deltas add
        under basic composition, so a Gaussian-noise ledger at step i is
        honestly (epsilon(), i * delta)-DP — including a scheduled curve
        wrapping a Gaussian inner.  Pure-epsilon (Laplace) curves spend 0."""
        if self.distribution == "gaussian":
            return self.step * self.delta
        return 0.0

    def sensitivity(self) -> float:
        return sensitivity(self.step, self.mu, self.grad_bound)

    def sigma_schedule(self, horizon: int, eps_target: float) -> float:
        """Fixed sigma to guarantee eps_target at `horizon` steps."""
        if self.curve == "gaussian":
            return gaussian_sigma_for_epsilon(horizon, self.mu,
                                              self.grad_bound, eps_target,
                                              self.delta)
        return sigma_for_epsilon(horizon, self.mu, self.grad_bound,
                                 eps_target)


# ------------------------------------------------- per-server async ledger --


@dataclass
class AsyncAccountant:
    """Per-server release ledgers for the event-driven executor.

    Once servers stop releasing in lockstep (repro_torch.core.events), "the"
    epsilon of the run is no longer one composed curve: each server
    releases at ITS OWN realized cadence and realized sampling rate q, and
    the privacy surface is per-server (cf. the topology-dependent
    decentralized bounds of arXiv:2312.07956).  This extension keeps one
    :class:`PrivacyAccountant` per server, advances server p's ledger only
    on the ticks p actually flushed (``record_round`` /
    ``record_schedule`` consume the ``(flushed, q)`` schedule an
    :class:`~repro_torch.core.events.engine.AsyncRunResult` carries), and
    reports the worst server's spend as the headline number.

    The synchronous lockstep schedule — every server flushing every tick
    at the same q — is a pinned special case: every per-server ledger then
    equals the scalar accountant's, so ``epsilon()`` /
    ``amplified_epsilon()`` reproduce the synchronous curves exactly
    (unit-pinned in tests/test_torch_events.py).
    """
    servers: list

    @classmethod
    def from_profile(cls, profile, mu: float, grad_bound: float, P: int
                     ) -> "AsyncAccountant":
        """One ledger per server, each configured like
        :meth:`PrivacyAccountant.from_profile`."""
        ledgers = [PrivacyAccountant.from_profile(profile, mu, grad_bound)
                   for _ in range(P)]
        for p, acc in enumerate(ledgers):
            acc.owner = f"server{p}"
        return cls(ledgers)

    @property
    def P(self) -> int:
        return len(self.servers)

    @property
    def releases(self) -> list:
        """Per-server release counts so far."""
        return [acc.step for acc in self.servers]

    def record_round(self, flushed, q=None) -> None:
        """Advance the ledgers of the servers that flushed this tick.

        ``flushed``: [P] bool; ``q``: [P] realized per-flush sampling
        rates (entries of non-flushing servers ignored; None charges each
        ledger's default rate)."""
        for p, did in enumerate(flushed):
            if did:
                qp = None if q is None else float(q[p])
                if qp is not None and qp <= 0.0:
                    qp = None   # schedule rows store 0 for "no flush"
                self.servers[p].advance(1, q=qp)

    def record_schedule(self, flushed, q=None) -> None:
        """Record a whole run's [T, P] release schedule (the
        ``AsyncRunResult.flushed`` / ``.q`` arrays)."""
        for t in range(len(flushed)):
            self.record_round(flushed[t], None if q is None else q[t])

    def per_server_epsilon(self) -> list:
        return [acc.epsilon() for acc in self.servers]

    def epsilon(self) -> float:
        """Worst-server composed epsilon (0 with no servers/releases)."""
        eps = self.per_server_epsilon()
        return max(eps) if eps else 0.0

    def amplified_epsilon(self) -> float:
        """Worst-server composed epsilon under subsampling amplification,
        against each server's own realized q history."""
        eps = [acc.amplified_epsilon() for acc in self.servers]
        return max(eps) if eps else 0.0

    def amplified_delta(self) -> float:
        return max((acc.amplified_delta() for acc in self.servers),
                   default=0.0)

    def delta_spent(self) -> float:
        return max((acc.delta_spent() for acc in self.servers), default=0.0)
