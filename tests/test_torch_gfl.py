"""The port's GFL round and engine against ``repro.core`` with the
reference's draws replayed (``test_torch_parity``), on the CPU at small sizes.

Tolerances: one round, params atol 1e-5 (the parity contract); 10-round
trajectories, params atol 1e-4 and MSD rtol 1e-3 (f32 reordering, carried
through ten rounds); the global solve, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GFLConfig as RefConfig
from repro.core import gfl as ref_gfl
from repro.core.privacy.accountant import epsilon_at
from repro.core.simulate import generate_problem as ref_generate
from repro.core.simulate import make_grad_fn as ref_grad_fn
from repro.core.simulate import run_gfl as ref_run_gfl
from repro.core.topology import combination_matrix
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import gfl_state_from_numpy, problem_from_numpy
from repro_torch.core import gfl
from repro_torch.core.population.engine import run_gfl_population
from repro_torch.core.simulate import _solve_global, make_grad_fn, run_gfl
from repro_torch.draws import Draws, ReplayDraws

from test_torch_parity import gfl_round_draws, run_gfl_draws

SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
P, K, N, M = 4, 6, 20, 2


@pytest.fixture(scope="module")
def ref_problem():
    return ref_generate(jax.random.PRNGKey(0), P=P, K=K, N=N, M=M)


@pytest.fixture(scope="module")
def problem(ref_problem):
    return problem_from_numpy(ref_problem.features, ref_problem.labels,
                              ref_problem.rho, ref_problem.w_opt,
                              device="cpu")


def _cfg_kw(scheme, iters=10, **kw):
    base = dict(num_servers=P, clients_per_server=K, privacy=scheme,
                sigma_g=0.3, mu=0.1, topology="ring", grad_bound=5.0,
                epsilon_target=epsilon_at(iters, 0.1, 5.0, 0.3),
                epsilon_horizon=iters)
    base.update(kw)
    return base


def test_solve_global_on_reference_features(ref_problem, problem):
    w = _solve_global(problem.features, problem.labels, problem.rho)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_problem.w_opt),
                               atol=1e-5)


def test_client_grads_match_jax_grad(ref_problem, problem):
    rng = np.random.default_rng(0)
    params = rng.standard_normal((P, M)).astype(np.float32)
    h = rng.standard_normal((P, 3, 5, M)).astype(np.float32)
    gam = np.where(rng.random((P, 3, 5)) < 0.5, 1.0, -1.0).astype(np.float32)
    want = ref_gfl._client_grads(jnp.asarray(params),
                                 (jnp.asarray(h), jnp.asarray(gam)),
                                 ref_grad_fn(0.01))
    got = gfl._client_grads(torch.tensor(params),
                            (torch.tensor(h), torch.tensor(gam)),
                            make_grad_fn(0.01))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_one_gfl_round(scheme, use_kernels, ref_problem):
    """One direct gfl_round (concrete step) with the same draws."""
    L, B = 5, 4
    kw = _cfg_kw(scheme, use_kernels=use_kernels)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    rng = np.random.default_rng(1)
    params = rng.standard_normal((P, M)).astype(np.float32)
    h = rng.standard_normal((P, L, B, M)).astype(np.float32)
    gam = np.where(rng.random((P, L, B)) < 0.5, 1.0, -1.0).astype(np.float32)
    A = combination_matrix("ring", P)
    key = jax.random.PRNGKey(5)
    want = ref_gfl.gfl_round(jnp.asarray(params),
                             (jnp.asarray(h), jnp.asarray(gam)), key,
                             A=jnp.asarray(A, jnp.float32),
                             grad_fn=ref_grad_fn(0.01), cfg=rcfg)
    draws = ReplayDraws([gfl_round_draws(rcfg, key, P, L, M)], device="cpu")
    state = gfl_state_from_numpy(params, 0, device="cpu")
    got = gfl.gfl_round(state.params, (torch.tensor(h), torch.tensor(gam)),
                        draws, A=A, grad_fn=make_grad_fn(0.01), cfg=tcfg,
                        step=0)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_gfl_trajectory_with_injected_draws(scheme, use_kernels,
                                                ref_problem, problem):
    iters, B, seed = 10, 5, 3
    kw = _cfg_kw(scheme, iters=iters, use_kernels=use_kernels)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    msd_r, params_r = ref_run_gfl(ref_problem, rcfg, iters=iters,
                                  batch_size=B, seed=seed)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K, N, M, iters=iters,
                                      batch_size=B, seed=seed), device="cpu")
    msd, params = run_gfl(problem, tcfg, iters=iters, batch_size=B,
                          draws=draws)
    assert draws.remaining == 0
    np.testing.assert_allclose(params.numpy(), np.asarray(params_r),
                               atol=1e-4)
    np.testing.assert_allclose(msd, np.asarray(msd_r), rtol=1e-3)


@pytest.mark.parametrize("scheme", ["hybrid", "iid_dp"])
def test_combine_every_trajectory_with_injected_draws(scheme, ref_problem,
                                                      problem):
    iters, B = 6, 5
    kw = _cfg_kw(scheme, iters=iters, combine_every=3, clients_sampled=4)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    msd_r, params_r = ref_run_gfl(ref_problem, rcfg, iters=iters,
                                  batch_size=B, seed=2)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K, N, M, iters=iters,
                                      batch_size=B, seed=2), device="cpu")
    msd, params = run_gfl(problem, tcfg, iters=iters, batch_size=B,
                          draws=draws)
    np.testing.assert_allclose(params.numpy(), np.asarray(params_r),
                               atol=1e-4)
    np.testing.assert_allclose(msd, np.asarray(msd_r), rtol=1e-3)


def test_scan_is_the_loop_recording_every_round(problem):
    cfg = GFLConfig(**_cfg_kw("hybrid", use_kernels=True))
    loop = run_gfl_population(problem, cfg, iters=6, batch_size=5, seed=4,
                              record_every=2)
    scan = run_gfl_population(problem, cfg, iters=6, batch_size=5, seed=4,
                              record_every=2, scan=True)
    assert np.array_equal(loop.msd, scan.msd) and len(loop.msd) == 3
    assert torch.equal(loop.params, scan.params)
    assert loop.accountant.step == 6
    assert np.all(loop.q == 1.0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_generator_runs_repeat_and_kernels_match(scheme, problem):
    """Torch-seeded runs: the same seed repeats bit for bit, and the
    kernel path agrees with the reference path on the same streams (masks
    cancel, iid noise comes from the same client stream)."""
    cfg = GFLConfig(**_cfg_kw(scheme))
    kern = dataclasses.replace(cfg, use_kernels=True)
    m0, p0 = run_gfl(problem, cfg, iters=5, batch_size=5, seed=7)
    m1, p1 = run_gfl(problem, kern, iters=5, batch_size=5, seed=7)
    m2, p2 = run_gfl(problem, kern, iters=5, batch_size=5, seed=7)
    assert np.array_equal(m1, m2) and torch.equal(p1, p2)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), atol=1e-5)
    assert np.all(np.isfinite(m1))


def test_draw_streams_are_independent():
    d = Draws(11, "cpu")
    a = d.laplace_uniform(3, "client", (5,))
    assert torch.equal(a, Draws(11, "cpu").laplace_uniform(3, "client", (5,)))
    assert not torch.equal(a, d.laplace_uniform(3, "combine", (5,)))
    assert not torch.equal(a, d.laplace_uniform(4, "client", (5,)))
    ci, bi = d.cohort(0, 3, 6, 20, 4, 5)
    assert ci.shape == (3, 4) and bi.shape == (3, 4, 5)
    for row in ci.tolist() + bi.reshape(-1, 5).tolist():
        assert len(set(row)) == len(row)          # without replacement


def test_replay_rejects_out_of_order_requests():
    d = ReplayDraws([[("combine", "normal", np.zeros((2, 3)))]], device="cpu")
    with pytest.raises(RuntimeError, match="replay order"):
        d.laplace_uniform(0, "combine", (2, 3))


@pytest.mark.parametrize("field,value", [
    ("fault", "links:0.1"), ("cohort", "importance"),
    ("population", "synthetic:iid"), ("async_spec", "async"),
    ("telemetry", "memory"), ("sanitize", True)])
def test_unported_options_raise(field, value, problem, tmp_path,
                                monkeypatch):
    """Options of later slices run now.  Faults, weighted cohorts and lazy
    populations (slice 3): a fault on the weighted path, an importance
    cohort, a population built from its spec; an async spec (slice 4),
    which the synchronous engine ignores, as the reference's does (the
    event engine reads it); telemetry and the sanitizer (slice 5), which
    leave the run bitwise as it is without them."""
    from repro_torch.core.population import run_gfl_population
    kw = {field: value}
    if field == "fault":
        kw["cohort"] = "importance"
    cfg = GFLConfig(**_cfg_kw("none", **kw))
    if field in ("fault", "cohort", "population", "async_spec"):
        source = None if field == "population" else problem
        res = run_gfl_population(source, cfg, iters=2, batch_size=5,
                                 device="cpu")
        assert np.isfinite(res.msd).all() and res.msd.shape == (2,)
        return
    # telemetry and the sanitizer (slice 5) run too: bitwise the plain run
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path))
    msd, params = run_gfl(problem, cfg, iters=2, batch_size=5)
    want = run_gfl(problem, GFLConfig(**_cfg_kw("none")), iters=2,
                   batch_size=5)
    assert msd.tolist() == want[0].tolist() and torch.equal(params, want[1])


def test_init_state_and_centroid():
    s = gfl.init_state(3, 2, device="cpu")
    assert s.step == 0 and torch.equal(s.params, torch.zeros(3, 2))
    p = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(gfl.centroid(p), torch.tensor([2.0, 3.0]))
    g = torch.tensor([[3.0, 4.0], [0.3, 0.4]])
    np.testing.assert_allclose(gfl.clip_to_bound(g, 1.0).numpy(),
                               [[0.6, 0.8], [0.3, 0.4]], atol=1e-7)


def test_logistic_loss_matches_reference():
    from repro.core.simulate import logistic_loss as ref_loss
    from repro_torch.core.simulate import logistic_loss
    rng = np.random.default_rng(5)
    w = rng.standard_normal(M).astype(np.float32)
    h = rng.standard_normal((40, M)).astype(np.float32)
    gam = np.where(rng.random(40) < 0.5, 1.0, -1.0).astype(np.float32)
    want = ref_loss(jnp.asarray(w), jnp.asarray(h), jnp.asarray(gam), 0.01)
    got = logistic_loss(torch.tensor(w), torch.tensor(h), torch.tensor(gam),
                        0.01)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_survivor_weights_match_reference():
    alive = np.array([[1, 0, 1], [0, 0, 0]], bool)
    fw_r, nw_r = ref_gfl._survivor_weights(jnp.asarray(alive))
    fw, nw = gfl._survivor_weights(torch.tensor(alive))
    np.testing.assert_array_equal(fw.numpy(), np.asarray(fw_r))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(nw_r))
    assert gfl._survivor_weights(None) == (None, None)


def test_run_schemes_covers_every_mechanism():
    from repro_torch.core.simulate import run_schemes
    prob, out = run_schemes(0, iters=3, P=3, K=4, repeats=1, batch_size=5,
                            device="cpu")
    assert sorted(out) == sorted(SCHEMES)
    assert all(v.shape == (3,) and np.all(np.isfinite(v))
               for v in out.values())
    assert prob.features.shape == (3, 4, 100, 2)
