"""The round graph's staged rounds on the CPU: the host stage and device
body that ``core/population/graphed.py`` captures as a CUDA graph on a
card, run eagerly here, against the eager executor and against the
reference with its draws replayed.

Tolerances: staged against eager bitwise (the same ops on the same
draws, in every mechanism, kernels on and off, ``combine_every`` 1 and 2,
static, null fault spec and every fault at once); against the reference,
one round's params within atol 1e-5 (the parity contract) and 8-round
trajectories within params atol 1e-4 and MSD rtol 1e-3, as
``test_torch_gfl.py`` and ``test_torch_resilience.py`` hold the eager
executor; reseeded generators and the sigma table bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GFLConfig as RefConfig
from repro.core.population.engine import run_gfl_population as ref_run_pop
from repro.core.privacy.accountant import scheduled_sigma_at as ref_sigma_at
from repro.core.simulate import generate_problem as ref_generate
from repro_torch import kernels as K
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import problem_from_numpy
from repro_torch.core import gfl
from repro_torch.core.population import engine, graphed
from repro_torch.core.population.engine import run_gfl_population
from repro_torch.core.privacy.accountant import epsilon_at
from repro_torch.core.privacy.mechanism import get_mechanism
from repro_torch.core.privacy.noise import f32_scalar
from repro_torch.core.resilience import TopologyProcess
from repro_torch.core.simulate import (base_combination_matrix, make_grad_fn,
                                       run_gfl)
from repro_torch.draws import STREAMS, Draws, ReplayDraws

from test_torch_parity import run_gfl_draws

SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
P, K_CLIENTS, N, M = 4, 8, 20, 2
FAULTS = {"static": "none", "null": "links:0.0+dropout:0.0",
          "all": "links:0.2+outage:0.1+straggler:0.3,stale=2+dropout:0.3"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, which torch's thread pool slows
    when the test run's other processes hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_problem():
    return ref_generate(jax.random.PRNGKey(0), P=P, K=K_CLIENTS, N=N, M=M)


@pytest.fixture(scope="module")
def problem(ref_problem):
    return problem_from_numpy(ref_problem.features, ref_problem.labels,
                              ref_problem.rho, ref_problem.w_opt,
                              device="cpu")


def _kw(scheme, fault="none", iters=8, **kw):
    base = dict(num_servers=P, clients_per_server=K_CLIENTS,
                clients_sampled=5, privacy=scheme, sigma_g=0.3, mu=0.1,
                topology="ring", grad_bound=5.0, fault=fault,
                topology_seed=3,
                epsilon_target=epsilon_at(iters, 0.1, 5.0, 0.3),
                epsilon_horizon=iters)
    base.update(kw)
    return base


def staged_run(problem, cfg, iters, *, seed=3, B=5, record_every=1,
               draws=None):
    """``run_gfl_population``'s run with its rounds staged (host stage,
    then body on the step's buffers), eagerly: what the round graph
    captures.  Returns (msd, params, gaps, ages)."""
    pop = engine.as_population(problem)
    A = base_combination_matrix(cfg, P)
    proc = (None if cfg.fault == "none" else
            TopologyProcess(A, cfg.fault, seed=cfg.topology_seed))
    return engine._run_pure_graph(
        pop, cfg, A, proc, make_grad_fn(pop.rho), cfg.effective_clients, B,
        iters, record_every, pop.w_ref,
        draws if draws is not None else Draws(seed, "cpu"), capture=False)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("tau", [1, 2])
@pytest.mark.parametrize("path", sorted(FAULTS))
def test_staged_rounds_are_the_eager_step(path, tau, use_kernels, scheme,
                                          problem):
    iters = 7
    cfg = GFLConfig(**_kw(scheme, FAULTS[path], iters,
                          use_kernels=use_kernels, combine_every=tau))
    want = run_gfl_population(problem, cfg, iters=iters, batch_size=5,
                              seed=3, record_every=2)
    msd, params, gaps, ages = staged_run(problem, cfg, iters, record_every=2)
    assert torch.equal(params, want.params)
    assert msd.tolist() == want.msd.tolist() and len(msd) == 4
    if path == "static":
        assert gaps is None and ages is None
    else:
        assert np.array_equal(gaps, want.gaps)
        assert ages.dtype == np.int32
        assert np.array_equal(ages, want.staleness)


def test_staged_scan_is_the_eager_scan(problem):
    cfg = GFLConfig(**_kw("hybrid", use_kernels=True))
    want = run_gfl_population(problem, cfg, iters=6, batch_size=5, seed=4,
                              record_every=2, scan=True, executor="eager")
    msd, params, _, _ = staged_run(problem, cfg, 6, seed=4, record_every=2)
    assert torch.equal(params, want.params)
    assert msd.tolist() == want.msd.tolist()


def _reference_cases():
    for scheme in SCHEMES:
        for use_kernels in (False, True):
            yield "static", scheme, use_kernels, 5
        # the reference's Pallas path numbers mask pairs by L padded to 8
        # under dropout: kernels on at L = 8 (test_torch_resilience.py)
        yield "all", scheme, False, 5
    yield "all", "hybrid", True, 8
    yield "all", "gaussian_dp", True, 8


@pytest.mark.parametrize("path,scheme,use_kernels,L",
                         list(_reference_cases()))
def test_staged_round_matches_the_reference(path, scheme, use_kernels, L,
                                            ref_problem, problem):
    """One staged round against the reference's, its draws replayed."""
    kw = _kw(scheme, FAULTS[path], 1, use_kernels=use_kernels,
             clients_sampled=L)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    want = ref_run_pop(ref_problem, rcfg, iters=1, batch_size=5, seed=3)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K_CLIENTS, N, M, iters=1,
                                      batch_size=5, seed=3), device="cpu")
    msd, params, _, _ = staged_run(problem, tcfg, 1, draws=draws)
    assert draws.remaining == 0
    np.testing.assert_allclose(params.numpy(), np.asarray(want.params),
                               atol=1e-5)
    np.testing.assert_allclose(msd, np.asarray(want.msd), rtol=1e-5)


@pytest.mark.parametrize("path,scheme,use_kernels,tau", [
    ("static", "hybrid", True, 1), ("static", "iid_dp", True, 1),
    ("static", "scheduled", True, 1), ("static", "hybrid", True, 2),
    ("static", "gaussian_dp", False, 2), ("all", "hybrid", False, 1),
    ("all", "scheduled", False, 1)])
def test_staged_trajectory_matches_the_reference(path, scheme, use_kernels,
                                                 tau, ref_problem, problem):
    iters = 8
    kw = _kw(scheme, FAULTS[path], iters, use_kernels=use_kernels,
             combine_every=tau)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    want = ref_run_pop(ref_problem, rcfg, iters=iters, batch_size=5, seed=3)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K_CLIENTS, N, M, iters=iters,
                                      batch_size=5, seed=3), device="cpu")
    msd, params, gaps, ages = staged_run(problem, tcfg, iters, draws=draws)
    assert draws.remaining == 0
    np.testing.assert_allclose(params.numpy(), np.asarray(want.params),
                               atol=1e-4)
    np.testing.assert_allclose(msd, np.asarray(want.msd), rtol=1e-3)
    if path != "static":
        assert np.array_equal(gaps, want.gaps)
        assert np.array_equal(ages, want.staleness)


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_reseeded_generators_draw_what_fresh_ones_draw(stream):
    """One persistent generator a stream, reseeded for each round (at the
    draw, or by ``stage``), gives a fresh Generator's bits."""
    d = Draws(11, "cpu")
    for step in (0, 5, 2, 9):
        fresh = torch.Generator().manual_seed(d.round_seed(step, stream))
        if step == 2:
            d.stage(step)
        got = d.normal(step, stream, (3, 7))
        assert torch.equal(got, torch.randn((3, 7), generator=fresh))
    fresh = torch.Generator().manual_seed(d.round_seed(4, "cohort"))
    ci, bi = d.cohort(4, 3, 6, 20, 4, 5)
    keys = torch.rand((3, 6), generator=fresh)
    assert torch.equal(ci, torch.argsort(keys, dim=1, stable=True)[:, :4])


def test_a_second_draw_from_a_round_and_stream_raises():
    d = Draws(2, "cpu")
    d.normal(3, "client", (4,))
    d.normal(3, "combine", (4,))          # another stream: fine
    d.normal(4, "client", (4,))           # another round: fine
    with pytest.raises(RuntimeError, match="round 3 drew from the 'client'"):
        d.laplace_uniform(3, "client", (4,))
    d.stage(7)
    d.cohort(7, 3, 6, 20, 4, 5)
    with pytest.raises(RuntimeError, match="drawn from once"):
        d.cohort(7, 3, 6, 20, 4, 5)


@pytest.mark.parametrize("inner", ["hybrid", "gaussian_dp", "iid_dp"])
def test_sigma_table_is_sigma_at_in_f32(inner):
    cfg = GFLConfig(**_kw(f"scheduled:{inner}", iters=12))
    mech = get_mechanism(cfg.privacy, cfg)
    table = mech.sigma_table(30, "cpu")
    assert table.dtype == torch.float32 and table.numel() >= 30
    want = np.array([mech.sigma_at(i) for i in range(table.numel())],
                    dtype=np.float32)
    assert np.array_equal(table.numpy().view(np.uint32), want.view(np.uint32))
    prof = mech.inner.noise_profile()
    ref = np.array([ref_sigma_at(i + 1, cfg.mu, cfg.grad_bound, 12,
                                 cfg.epsilon_target, prof.distribution,
                                 prof.delta) for i in range(30)], np.float32)
    assert np.array_equal(table[:30].numpy().view(np.uint32),
                          ref.view(np.uint32))
    assert mech.sigma_table(10, "cpu") is table       # made once
    assert mech.sigma_table(100, "cpu").numel() >= 100
    # the eager rounds read the table's entry on the device
    ctx = mech._inner_ctx(gfl.RoundContext(step=4, traced_step=True), "cpu")
    assert torch.equal(ctx.sigma, table[4]) and ctx.sigma_traced


@pytest.mark.parametrize("spec", ["hybrid", "scheduled", "none"])
def test_constant_sigma_has_no_table(spec):
    kw = _kw(spec)
    if spec == "scheduled":
        kw["epsilon_target"] = 0.0
    cfg = GFLConfig(**kw)
    assert get_mechanism(spec, cfg).sigma_table(5, "cpu") is None


def test_round_constants_are_made_once():
    a = f32_scalar(0.3, "cpu")
    assert a is f32_scalar(0.3, torch.device("cpu"))
    assert a.dtype == torch.float32 and a.dim() == 0
    assert a.numpy().view(np.uint32) == np.float32(0.3).view(np.uint32)
    t = torch.tensor(1.5)
    assert f32_scalar(t, "cpu") is t                  # a staged sigma


def test_executor_choice():
    cpu = torch.device("cpu")
    assert graphed.resolve_executor(None, cpu) == "eager"
    assert graphed.resolve_executor("eager", cpu) == "eager"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphed.resolve_executor("graph", cpu)
    with pytest.raises(ValueError, match="unknown executor"):
        graphed.resolve_executor("jit", cpu)


def test_graph_executor_on_the_cpu_raises(problem):
    cfg = GFLConfig(**_kw("hybrid"))
    with pytest.raises(ValueError, match="executor='eager'"):
        run_gfl(problem, cfg, iters=2, batch_size=5, executor="graph")


def test_replayed_draws_refuse_the_graph():
    d = ReplayDraws([[]], device="cpu")
    d.stage(0)                            # the staged rounds run on them
    with pytest.raises(RuntimeError, match="executor='eager'"):
        d.generators()


def test_fold_spec_must_hold_for_the_run(problem, monkeypatch):
    """K2 takes the fold's sigma by value, so a graph holds it: a run whose
    fold spec changed between rounds raises at the host stage."""
    cfg = GFLConfig(**_kw("hybrid", use_kernels=True))
    step = gfl.StagedStep(base_combination_matrix(cfg, P),
                          make_grad_fn(0.01), cfg, P, M, 4, "cpu")
    draws = Draws(0, "cpu")
    assert step.stage(0, draws) is True
    spec = step.mech.fold_spec()
    monkeypatch.setattr(step.mech, "fold_spec",
                        lambda ctx=None: spec._replace(sigma=spec.sigma * 2))
    with pytest.raises(RuntimeError, match="fold spec"):
        step.stage(1, draws)


def test_replays_count_the_launches_they_hold():
    K.reset_launches()
    K.LAUNCHES["fold_apply"] += 1                 # a warm-up round
    for _ in range(3):
        K.count_replay({"fold_apply": 1, "graph_combine": 1})
    assert K.LAUNCHES["fold_apply"] == 4 and K.REPLAYED["fold_apply"] == 3
    assert K.LAUNCHES["graph_combine"] == K.REPLAYED["graph_combine"] == 3
    K.reset_launches()
    assert not any(K.LAUNCHES.values()) and not any(K.REPLAYED.values())
