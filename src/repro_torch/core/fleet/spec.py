"""Fleet-deployment specification: the ``fleet`` spec grammar (a copy of
``repro.core.fleet.spec``).

The multi-process server fleet (the reference's docs/fleet.md) is
configured by a compact spec string so deployments stay flat and hashable,
exactly like ``fault`` / ``cohort`` / ``async``::

    fleet
    fleet:transport=filelog
    fleet:transport=socket,retry=3,timeout=2.0,backoff=exp
    fleet:transport=inproc,retry=5,timeout=0.5,backoff=const,heartbeat=0.2

Fields
  ``transport``   message substrate every psi exchange and cohort dispatch
                  travels over: ``inproc`` (in-process queues — the
                  tier-1-safe realization), ``filelog`` (append-only
                  per-endpoint replay logs) or ``socket`` (TCP);
  ``retry``       bounded send/collect retry budget (attempts beyond the
                  first) before a worker is declared lost;
  ``timeout``     per-attempt receive timeout in seconds;
  ``backoff``     retry pacing: ``exp`` doubles the wait per attempt
                  (ClusterCoordinator-style schedule-and-retry), ``const``
                  keeps it fixed;
  ``heartbeat``   worker heartbeat period in seconds (feeds the
                  coordinator's heartbeat-age telemetry and loss
                  detection);
  ``ckpt_every``  write-ahead checkpoint cadence in ticks (1 = every tick;
                  crash recovery can lose at most this many ticks of
                  buffer fold — the chaos tests pin it to 1).

``fleet_to_spec`` is the canonical inverse of :func:`parse_fleet_spec`
(round-trip tested through the spec-grammar registry,
:mod:`repro_torch.core.specs`).
"""
from __future__ import annotations

from dataclasses import dataclass

TRANSPORTS = ("inproc", "filelog", "socket")
_BACKOFFS = ("exp", "const")

_DEFAULTS = {"transport": "inproc", "retry": 3, "timeout": 5.0,
             "backoff": "exp", "heartbeat": 0.5, "ckpt_every": 1}


@dataclass(frozen=True)
class FleetSpec:
    """Parsed ``fleet`` spec (see module docstring)."""
    transport: str = "inproc"
    retry: int = 3
    timeout: float = 5.0
    backoff: str = "exp"
    heartbeat: float = 0.5
    ckpt_every: int = 1

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown fleet transport {self.transport!r}; "
                             f"expected one of {TRANSPORTS}")
        if self.backoff not in _BACKOFFS:
            raise ValueError(f"unknown fleet backoff {self.backoff!r}; "
                             f"expected one of {_BACKOFFS}")
        if self.retry < 0:
            raise ValueError(f"retry must be >= 0, got {self.retry}")
        if self.timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {self.timeout}")
        if self.heartbeat <= 0:
            raise ValueError(f"heartbeat must be > 0, got {self.heartbeat}")
        if self.ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, "
                             f"got {self.ckpt_every}")

    def backoff_delay(self, attempt: int) -> float:
        """Wait before retry ``attempt`` (0-indexed): ``timeout * 2^a``
        under ``exp`` (TF ClusterCoordinator's schedule-and-retry pacing),
        flat ``timeout`` under ``const``."""
        if self.backoff == "exp":
            return self.timeout * (2.0 ** attempt)
        return self.timeout

    def to_spec(self) -> str:
        """Inverse of :func:`parse_fleet_spec` (canonical form: keys in
        declaration order, defaults omitted, bare ``fleet`` when every
        field is default)."""
        parts = []
        for key in ("transport", "retry", "timeout", "backoff", "heartbeat",
                    "ckpt_every"):
            val = getattr(self, key)
            if val == _DEFAULTS[key]:
                continue
            parts.append(f"{key}={val:g}" if isinstance(val, float)
                         else f"{key}={val}")
        return "fleet:" + ",".join(parts) if parts else "fleet"


def parse_fleet_spec(spec: str) -> FleetSpec:
    """``fleet[:key=value,...]`` -> :class:`FleetSpec`."""
    spec = (spec or "fleet").strip()
    head, sep, rest = spec.partition(":")
    if head != "fleet":
        raise ValueError(f"fleet spec must start with 'fleet', got {spec!r}")
    if sep and not rest:
        raise ValueError(f"empty fleet argument list in {spec!r}")
    kw: dict = {}
    if rest:
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in _DEFAULTS:
                raise ValueError(
                    f"bad fleet argument {part!r} in {spec!r}; expected "
                    f"key=value with key in {tuple(_DEFAULTS)}")
            if key in kw:
                raise ValueError(f"duplicate fleet argument {key!r} in "
                                 f"{spec!r}")
            if key in ("transport", "backoff"):
                kw[key] = val.strip()
            elif key in ("retry", "ckpt_every"):
                kw[key] = int(val)
            else:
                kw[key] = float(val)
    return FleetSpec(**kw)
