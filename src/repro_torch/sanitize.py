"""Runtime sanitizer mode (port of ``repro.sanitize``).

Enabled per run by ``GFLConfig.sanitize`` or process-wide by
``REPRO_SANITIZE=1``.  Inside :func:`sanitizer_scope` the engines run
their key-reuse and non-finite checks, and every engine cross-checks a
:class:`ReleaseLedger` (releases performed against releases charged to the
accountant), so an accounting drift that static analysis cannot see fails
loudly instead of silently under-reporting epsilon.

The reference's scope turns on jax's ``jax_debug_key_reuse`` and
``jax_debug_nans``.  Here the scope sets a module-level flag the engines
read:

* key reuse is the :class:`~repro_torch.draws.Draws` second-draw guard
  (each ``(round, stream)`` is drawn from once), which always holds; in
  the scope :class:`~repro_torch.draws.ReplayDraws` keeps the same guard;
* NaN debugging is a finite check (:func:`check_finite`) on the run's
  [T] traces and final params, made after the run on the host: a check
  inside a captured round would have to sync with it.

Checks are O(1) syncs a run.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

ENV_FLAG = "REPRO_SANITIZE"
_FALSY = ("", "0", "false", "False", "no")

_ACTIVE = False


class SanitizerError(AssertionError):
    """An invariant the sanitizer enforces was violated at runtime."""


def sanitize_enabled(cfg=None) -> bool:
    """True when sanitize mode is on for this run (config field wins,
    else the ``REPRO_SANITIZE`` environment flag)."""
    if cfg is not None and getattr(cfg, "sanitize", False):
        return True
    return os.environ.get(ENV_FLAG, "0") not in _FALSY


def sanitizer_active() -> bool:
    """True inside :func:`sanitizer_scope`."""
    return _ACTIVE


@contextmanager
def sanitizer_scope():
    """Turn on the key-reuse and non-finite checks for the dynamic extent
    of a run, restoring the previous state on exit."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = True
    try:
        yield
    finally:
        _ACTIVE = previous


def check_finite(what: str, value) -> None:
    """Raise :class:`SanitizerError` when ``value`` (a tensor or an array,
    read once) holds a non-finite entry and the scope is active.  Called
    after a run, never inside a captured round."""
    if not _ACTIVE or value is None:
        return
    import numpy as np
    arr = value.detach().cpu().numpy() if hasattr(value, "detach") \
        else np.asarray(value)
    if not np.all(np.isfinite(arr)):
        raise SanitizerError(f"non-finite {what} under sanitize mode")


@dataclass
class ReleaseLedger:
    """Counts noise releases performed vs releases charged.

    Engines record a release per protocol round actually executed and a
    charge per accountant advance; :meth:`cross_check` raises when the two
    diverge — the "release the accountant never heard about" bug class
    caught at runtime.
    """
    released: int = 0
    charged: int = 0

    def record_release(self, n: int = 1) -> None:
        self.released += int(n)

    def record_charge(self, n: int = 1) -> None:
        self.charged += int(n)

    def charge_from(self, accountant) -> None:
        """Record charges straight off an accountant: a
        ``PrivacyAccountant`` exposes ``step`` (total releases charged),
        an ``AsyncAccountant`` a per-server ``releases`` list (every
        flushed release must be on some ledger)."""
        if hasattr(accountant, "releases"):
            rel = accountant.releases
            self.record_charge(sum(rel))
        else:
            self.record_charge(accountant.step)

    def cross_check(self) -> None:
        if self.released != self.charged:
            raise SanitizerError(
                f"accountant ledger mismatch: {self.released} noise "
                f"release(s) performed but {self.charged} charged — "
                f"every release must be charged exactly once "
                f"(PrivacyAccountant.advance / AsyncAccountant.record_*)")
