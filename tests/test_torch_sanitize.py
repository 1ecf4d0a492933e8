"""The port's sanitizer mode (``repro_torch.sanitize``): the cases of the
reference's tests/test_sanitize.py on the port, and what the port's scope
stands for — the draws' second-draw guard (eager, and ReplayDraws inside
the scope) and finite checks after the run on every engine.

Small shapes on the CPU; one intra-op thread (many small ops)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import GFLConfig
from repro_torch.core.events.engine import run_gfl_async
from repro_torch.core.population.engine import run_gfl_population
from repro_torch.core.simulate import run_gfl
from repro_torch.draws import Draws, ReplayDraws
from repro_torch.sanitize import (ENV_FLAG, ReleaseLedger, SanitizerError,
                                  check_finite, sanitize_enabled,
                                  sanitizer_active, sanitizer_scope)

CFG = GFLConfig(num_servers=3, clients_per_server=4, clients_sampled=2,
                population="synthetic:iid,sigma=1.0,n=20,dim=4")
ASYNC = "async:buffer=2,latency=fixed:1,max_stale=4"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sanitize_enabled_sources(monkeypatch):
    monkeypatch.delenv(ENV_FLAG, raising=False)
    assert not sanitize_enabled()
    assert not sanitize_enabled(CFG)
    assert sanitize_enabled(dataclasses.replace(CFG, sanitize=True))
    monkeypatch.setenv(ENV_FLAG, "1")
    assert sanitize_enabled()
    assert sanitize_enabled(CFG)
    monkeypatch.setenv(ENV_FLAG, "0")
    assert not sanitize_enabled(CFG)


def test_sanitizer_scope_sets_and_restores_flags():
    before = sanitizer_active()
    with sanitizer_scope():
        assert sanitizer_active()
        with sanitizer_scope():
            assert sanitizer_active()
        assert sanitizer_active()       # the inner exit restores, not clears
    assert sanitizer_active() == before


def test_sanitizer_scope_catches_nan():
    check_finite("x", torch.tensor([float("nan")]))   # outside: no check
    with sanitizer_scope():
        check_finite("x", torch.ones(3))
        with pytest.raises(SanitizerError, match="non-finite x"):
            check_finite("x", torch.log(torch.tensor([-1.0])))
        with pytest.raises(SanitizerError):
            check_finite("x", np.array([1.0, np.inf]))


def test_ledger_cross_check():
    led = ReleaseLedger()
    led.record_release(4)
    led.record_charge(4)
    led.cross_check()
    led.record_release()
    with pytest.raises(SanitizerError):
        led.cross_check()


def test_ledger_charge_from_accountants():
    class Sync:
        step = 5

    class Async:
        releases = [2, 3, 1]

    led = ReleaseLedger()
    led.charge_from(Sync())
    assert led.charged == 5
    led = ReleaseLedger()
    led.charge_from(Async())
    assert led.charged == 6


# ------------------------------------------------ engine integration
def test_population_run_attaches_charged_accountant():
    res = run_gfl_population(None, CFG, iters=5, batch_size=2, device="cpu")
    assert res.accountant is not None
    assert res.accountant.step == 5
    assert len(res.accountant.q_history) == 5
    np.testing.assert_allclose(res.accountant.q_history, res.q)
    assert res.accountant.epsilon() > 0


def test_population_run_under_sanitize_mode():
    cfg = dataclasses.replace(CFG, sanitize=True)
    res = run_gfl_population(None, cfg, iters=4, batch_size=2, device="cpu")
    assert res.accountant.step == 4
    assert np.all(np.isfinite(res.msd))
    assert not sanitizer_active()       # the scope is restored after the run


def test_population_sanitize_env_flag(monkeypatch):
    monkeypatch.setenv(ENV_FLAG, "1")
    res = run_gfl_population(None, CFG, iters=3, batch_size=2, device="cpu")
    assert res.accountant.step == 3


def test_async_run_attaches_schedule_charged_accountant():
    cfg = dataclasses.replace(CFG, async_spec=ASYNC, sanitize=True)
    res = run_gfl_async(None, cfg, ticks=6, batch_size=2, device="cpu")
    assert res.accountant is not None
    np.testing.assert_array_equal(res.accountant.releases, res.releases)
    assert res.accountant.epsilon() > 0


def test_weighted_path_realized_q_matches_accountant():
    cfg = dataclasses.replace(CFG, cohort="importance,floor=0.2",
                              sanitize=True)
    res = run_gfl_population(None, cfg, iters=3, batch_size=2, device="cpu")
    np.testing.assert_allclose(res.accountant.q_history, res.q)


# ------------------------------------------------ the port's scope
ENGINES = {
    "dense": dict(),
    "scan": dict(scan=True),
    "weighted": dict(cohort="importance,floor=0.2"),
    "events": dict(async_spec=ASYNC),
    "events_scan": dict(async_spec=ASYNC, scan=True),
}


def _run(engine, cfg_kw, **kw):
    over = dict(ENGINES[engine])
    scan = over.pop("scan", False)
    cfg = dataclasses.replace(CFG, **over, **cfg_kw)
    if "async_spec" in over:
        return run_gfl_async(None, cfg, ticks=4, batch_size=2, scan=scan,
                             device="cpu", **kw)
    return run_gfl_population(None, cfg, iters=4, batch_size=2, scan=scan,
                              device="cpu", **kw)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_nan_w_ref_raises_after_the_run(engine):
    """A planted non-finite value (a NaN w_ref) makes the MSD trace NaN:
    sanitize mode raises after the run; without it the run returns."""
    nan_ref = torch.full((4,), float("nan"))
    res = _run(engine, {}, w_ref=nan_ref)
    assert np.isnan(res.msd).all()
    with pytest.raises(SanitizerError, match="non-finite MSD"):
        _run(engine, {"sanitize": True}, w_ref=nan_ref)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_sanitize_is_bitwise_the_plain_run(engine):
    plain = _run(engine, {})
    checked = _run(engine, {"sanitize": True})
    assert torch.equal(plain.params, checked.params)
    assert plain.msd.tolist() == checked.msd.tolist()


def test_ledger_one_release_too_few_raises(monkeypatch):
    """An engine that charges one release fewer than it performed fails
    the cross-check (planted in the accountant's advance)."""
    from repro_torch.core.privacy import accountant as acc_mod
    real = acc_mod.PrivacyAccountant.advance
    calls = {"n": 0}

    def short(self, steps=1, q=None):
        calls["n"] += 1
        return real(self, 0 if calls["n"] == 1 else steps, q)

    monkeypatch.setattr(acc_mod.PrivacyAccountant, "advance", short)
    with pytest.raises(SanitizerError, match="4 noise release"):
        _run("dense", {"sanitize": True})
    calls["n"] = 0
    with pytest.raises(SanitizerError, match="ledger mismatch"):
        _run("events", {"sanitize": True})


def test_dense_run_gfl_sanitized(monkeypatch):
    from repro_torch import rng
    from repro_torch.core.simulate import generate_problem
    prob = generate_problem(rng(0, "cpu"), P=3, K=6, N=10, M=2)
    cfg = GFLConfig(num_servers=3, clients_per_server=6, clients_sampled=3,
                    privacy="hybrid", sanitize=True)
    msd, params = run_gfl(prob, cfg, iters=3, batch_size=4)
    assert np.isfinite(msd).all() and torch.isfinite(params).all()


def test_second_draw_raises_eagerly_and_for_replays_in_the_scope():
    """Key reuse: a second draw from one (round, stream) raises — always
    for Draws, and for ReplayDraws inside the sanitizer's scope."""
    d = Draws(0, "cpu")
    d.normal(0, "client", (2,))
    with pytest.raises(RuntimeError, match="drew from the 'client'"):
        d.normal(0, "client", (2,))
    entries = [[("client", "normal", np.zeros(2)),
                ("client", "normal", np.zeros(2))]]
    r = ReplayDraws(entries, device="cpu")
    r.normal(0, "client", (2,))
    r.normal(0, "client", (2,))          # outside the scope: in order
    with sanitizer_scope():
        r = ReplayDraws(entries, device="cpu")
        r.normal(0, "client", (2,))
        with pytest.raises(RuntimeError, match="drew from the 'client'"):
            r.normal(0, "client", (2,))
