"""The port's event engine (``repro_torch.core.events``) against
``repro.core.events``, on the CPU at small sizes.

Tolerances: spec parsing, ``to_spec`` and rejections equal to the
reference's; ``EventQueue`` realizations bit-exact (numpy on both sides);
trace intensities within atol 1e-6 of the reference's (``sin`` may differ
by an ulp between XLA and torch), arrival masks equal except where |u - p|
< 1e-6 (the number of such ties is recorded, zero expected); the buffer's
``fold_tick`` / ``flush`` within atol 1e-6; ``AsyncAccountant`` epsilons
equal; ``AsyncCohortDriver`` weights within atol 1e-6, flush masks and q
equal; the sync limit bitwise ``run_gfl_population``; ticks with the
reference's draws replayed (its cohort and privacy draws from its key
schedule, E = 8 so its Pallas fold numbers mask pairs by the true E):
params and MSD within atol 1e-5, flushed, events and drops equal,
staleness and q within atol 1e-6; the loop bitwise ``scan=True``; with an
always-on trace the flush, event, drop and staleness schedules, which
depend only on the numpy queue, equal to the reference's even with
torch-seeded cohorts.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.configs.base import GFLConfig as RefConfig
from repro.core import events as ref_events
from repro.core import sampling as ref_IS
from repro.core.population.engine import uniform_cohort_indices
from repro.core.population.population import DensePopulation as RefDense
from repro.core.privacy.mechanism import mechanism_for as ref_mechanism_for
from repro.core.resilience.faults import FaultModel as RefFaultModel
from repro.core.simulate import generate_problem as ref_generate
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import is_state_from_numpy, problem_from_numpy
from repro_torch.core.events import (
    AsyncCohortDriver,
    AsyncSpec,
    EventQueue,
    LatencySpec,
    engine,
    fold_tick,
    flush,
    init_buffers,
    parse_async_spec,
    parse_latency_spec,
    run_gfl_async,
    staleness_weights,
    trace_intensity_fn,
    weighted_fold,
)
from repro_torch.core.population import parse_trace_spec, run_gfl_population
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.resilience.faults import FaultModel
from repro_torch.draws import ReplayDraws

from test_torch_parity import round_draws

P, K, N, M = 4, 12, 20, 2
SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]


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
    return ref_generate(jax.random.PRNGKey(0), P=P, K=K, N=N, M=M)


@pytest.fixture(scope="module")
def problem(ref_problem):
    return problem_from_numpy(ref_problem.features, ref_problem.labels,
                              ref_problem.rho, ref_problem.w_opt,
                              device="cpu")


# ------------------------------------------------------------------ specs --


ASYNC_SPECS = ["none", "async", "async:buffer=8",
               "async:buffer=8,latency=lognorm:0.5,max_stale=4",
               "async:buffer=8,latency=exp:1.5,max_stale=4,alpha=0.5,rate=16",
               "async:buffer=3,latency=fixed:2,max_stale=2,alpha=0",
               "async:latency=fixed:0,rate=4", "async:alpha=1.25"]
ASYNC_BAD = ["async:buffer=0", "async:nope=3", "fancy:buffer=2",
             "async:buffer=two", "async:buffer=2,buffer=3",
             "async:max_stale=-1", "async:alpha=-0.5", "async:rate=-1",
             "async:latency=gamma:1", "async:buffer"]
LATENCY_SPECS = ["zero", "fixed:3", "exp:1.5", "lognorm:0.5", "fixed:0",
                 "", "exp:0"]
LATENCY_BAD = ["zero:1", "exp", "lognorm:", "gamma:0.5", "exp:x", "fixed:-1"]


@pytest.mark.parametrize("spec", ASYNC_SPECS)
def test_async_spec_equals_reference(spec):
    got, want = parse_async_spec(spec), ref_events.parse_async_spec(spec)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.events_per_tick, got.is_sync_limit) == (
        want.events_per_tick, want.is_sync_limit)
    assert got.to_spec() == want.to_spec()
    # the canonical form normalizes a zero-parameter latency to "zero"
    assert dataclasses.asdict(parse_async_spec(got.to_spec())) == \
        dataclasses.asdict(ref_events.parse_async_spec(want.to_spec()))


@pytest.mark.parametrize("spec", LATENCY_SPECS)
def test_latency_spec_equals_reference(spec):
    got = parse_latency_spec(spec)
    want = ref_events.parse_latency_spec(spec)
    assert (got.kind, got.param, got.is_zero) == (want.kind, want.param,
                                                 want.is_zero)
    assert got.to_spec() == want.to_spec()
    assert parse_latency_spec(got.to_spec()) == got


@pytest.mark.parametrize("bad", ASYNC_BAD)
def test_async_spec_rejections_equal_reference(bad):
    with pytest.raises(ValueError):
        parse_async_spec(bad)
    with pytest.raises(ValueError):
        ref_events.parse_async_spec(bad)


@pytest.mark.parametrize("bad", LATENCY_BAD)
def test_latency_spec_rejections_equal_reference(bad):
    with pytest.raises(ValueError):
        parse_latency_spec(bad)
    with pytest.raises(ValueError):
        ref_events.parse_latency_spec(bad)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 64),
       st.sampled_from(["zero", "fixed", "exp", "lognorm"]),
       st.integers(0, 400), st.integers(0, 8), st.integers(0, 300),
       st.integers(0, 64))
def test_async_spec_roundtrip_equals_reference(buffer, lkind, lparam,
                                               max_stale, alpha100, rate):
    lat = (LatencySpec() if lkind == "zero"
           else LatencySpec(lkind, lparam / 100))
    spec = AsyncSpec(buffer=buffer, latency=lat, max_stale=max_stale,
                     alpha=alpha100 / 100, rate=rate)
    text = spec.to_spec()
    rt = parse_async_spec(text)
    want = ref_events.parse_async_spec(text)
    assert dataclasses.asdict(rt) == dataclasses.asdict(want)
    assert rt.to_spec() == want.to_spec() == text
    assert parse_async_spec(rt.to_spec()) == rt


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 100), st.integers(0, 100), st.integers(0, 100),
       st.integers(1, 6), st.integers(0, 100))
def test_fault_spec_roundtrip_with_keywords(links, outage, straggler, stale,
                                            dropout):
    """The fault grammar the event engine refuses parts of, built with
    keywords (a positional build would shift ``outage_kill``)."""
    kw = dict(link_drop=links / 100, outage=outage / 100,
              straggler=straggler / 100, staleness=stale,
              client_dropout=dropout / 100)
    fm, ref = FaultModel(**kw), RefFaultModel(**kw)
    assert fm.to_spec() == ref.to_spec()
    from repro.core.resilience.faults import parse_fault_spec as ref_parse
    from repro_torch.core.resilience.faults import parse_fault_spec
    rt = parse_fault_spec(fm.to_spec())
    assert dataclasses.asdict(rt) == dataclasses.asdict(
        ref_parse(ref.to_spec()))
    assert parse_fault_spec(rt.to_spec()) == rt


# ------------------------------------------------------ the arrival layer --


@pytest.mark.parametrize("latency", ["lognorm:0.8", "exp:1.5", "fixed:2",
                                     "zero"])
def test_event_queue_bit_exact(latency):
    spec = f"async:buffer=4,latency={latency},max_stale=6,rate=3"
    got = EventQueue(5, parse_async_spec(spec), seed=11)
    want = ref_events.EventQueue(5, ref_events.parse_async_spec(spec),
                                 seed=11)
    for t in (0, 3, 17):
        (u1, a1), (u2, a2) = got.realize(t), want.realize(t)
        assert u1.dtype == u2.dtype and a1.dtype == a2.dtype
        assert np.array_equal(u1, u2) and np.array_equal(a1, a2)
    us, ages = got.realize_horizon(6)
    wus, wages = want.realize_horizon(6)
    assert us.shape == (6, 5, 3)
    assert np.array_equal(us, wus) and np.array_equal(ages, wages)


def _ties(u, p):
    return np.abs(u - p) < 1e-6


@pytest.mark.parametrize("trace", ["diurnal,period=12,min=0.3",
                                   "diurnal,period=7,min=0.05",
                                   "devclass,slow=0.4,p=0.2"])
@pytest.mark.parametrize("seed", range(3))
def test_trace_intensity_equals_reference(trace, seed, record_property):
    """Intensities at every tick of a run over random client ids within
    atol 1e-6 of the reference's traced ones, and the arrival masks
    ``u < p`` on the queue's uniforms equal except at ties."""
    Kc = 200
    tr = parse_trace_spec(trace)
    from repro.core.population.cohort import parse_trace_spec as ref_trace
    fn = trace_intensity_fn(tr, Kc, "cpu")
    ref_fn = jax.jit(ref_events.trace_intensity_fn(ref_trace(trace), Kc))
    queue = EventQueue(P, parse_async_spec("async:buffer=8,rate=16"),
                       seed=seed)
    rng = np.random.default_rng(seed)
    ties = 0
    for t in range(40):
        idx = rng.integers(0, Kc, (P, 16))
        got = fn(torch.tensor([t]), torch.from_numpy(idx)).numpy()
        want = np.asarray(ref_fn(jnp.int32(t), jnp.asarray(idx, jnp.int32)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        u, _ = queue.realize(t)
        tie = _ties(u, want)
        ties += int(tie.sum())
        assert np.array_equal((u < got)[~tie], (u < want)[~tie])
    record_property("intensity_ties", ties)
    assert trace_intensity_fn(parse_trace_spec("always"), Kc) is None


# ------------------------------------------- staleness-weighted buffering --


def test_staleness_weights_equal_reference():
    ages = np.asarray([0, 1, 2, 5, 17, 40], np.int32)
    for alpha in (0.0, 0.5, 1.0, 2.0, 0.37):
        got = staleness_weights(torch.from_numpy(ages), alpha).numpy()
        want = np.asarray(ref_events.staleness_weights(jnp.asarray(ages),
                                                       alpha))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert got[0] == 1.0 and (np.diff(got) <= 0).all()


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=20), min_size=1,
                max_size=12),
       st.floats(min_value=0.0, max_value=3.0, allow_nan=False))
def test_weighted_fold_equals_reference(ages, alpha):
    s = staleness_weights(torch.tensor(ages), alpha)
    x = torch.linspace(-2.0, 3.0, len(ages) * 3).reshape(len(ages), 3)
    got = weighted_fold(x, s).numpy()
    want = np.asarray(ref_events.weighted_fold(jnp.asarray(x.numpy()),
                                               jnp.asarray(s.numpy())))
    np.testing.assert_allclose(got, want, atol=1e-6)
    const = weighted_fold(torch.full((len(ages), 3), 2.5), s).numpy()
    np.testing.assert_allclose(const, 2.5, rtol=1e-6)


@pytest.mark.parametrize("select", [True, False])
def test_buffer_fold_flush_equal_reference(select):
    """Three ticks of fold and flush on random contributions, every server
    crossing its threshold at its own tick, against the reference's."""
    rng = np.random.default_rng(0)
    params = rng.normal(size=(3, 5)).astype(np.float32)
    got = init_buffers(torch.from_numpy(params))
    want = ref_events.init_buffers(jnp.asarray(params))
    for n in ([2, 3, 0], [2, 0, 1], [1, 4, 2]):
        c = rng.normal(size=(3, 5)).astype(np.float32)
        n = np.asarray(n, np.int32)
        w = (rng.uniform(0.2, 1.0, 3) * n).astype(np.float32)
        got = fold_tick(got, torch.from_numpy(c), torch.from_numpy(w),
                        torch.from_numpy(n))
        want = ref_events.fold_tick(want, jnp.asarray(c), jnp.asarray(w),
                                    jnp.asarray(n))
        g_did, g_psi, got = flush(got, 3, select=select)
        w_did, w_psi, want = ref_events.flush(want, 3, select=select)
        assert np.array_equal(g_did.numpy(), np.asarray(w_did))
        np.testing.assert_allclose(g_psi.numpy(), np.asarray(w_psi),
                                   atol=1e-6)
        for a, b in zip(got, want):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # the init cache is a copy: folding in place never writes the params
    assert init_buffers(torch.zeros(2, 2)).psi_cache.data_ptr() != \
        torch.zeros(2, 2).data_ptr()


# ------------------------------------------------- per-server accounting --


@pytest.mark.parametrize("scheme", SCHEMES)
def test_async_accountant_equals_reference(scheme):
    kw = dict(num_servers=3, clients_per_server=10, privacy=scheme,
              sigma_g=0.3, epsilon_target=50.0, epsilon_horizon=8)
    got = mechanism_for(GFLConfig(**kw)).async_accountant(3)
    want = ref_mechanism_for(RefConfig(**kw)).async_accountant(3)
    rng = np.random.default_rng(1)
    flushed = rng.random((8, 3)) < 0.6
    q = np.where(flushed, rng.uniform(0.05, 1.0, (8, 3)), 0.0)
    got.record_schedule(flushed, q)
    want.record_schedule(flushed, q)
    assert got.releases == want.releases
    assert got.per_server_epsilon() == want.per_server_epsilon()
    assert got.epsilon() == want.epsilon()
    assert got.amplified_epsilon() == want.amplified_epsilon()
    assert got.amplified_delta() == want.amplified_delta()
    assert got.delta_spent() == want.delta_spent()
    assert [a.owner for a in got.servers] == ["server0", "server1",
                                              "server2"]


def test_async_accountant_lockstep_pin():
    """Every server flushing every tick at one q: each per-server ledger
    is the scalar accountant's, through a run's own schedule."""
    cfg = GFLConfig(num_servers=3, clients_per_server=10, clients_sampled=4,
                    privacy="hybrid", sigma_g=0.3, topology="ring",
                    population="synthetic:iid", async_spec="async:buffer=4")
    res = run_gfl_async(None, cfg, ticks=6, batch_size=5, seed=0,
                        device="cpu")
    acc = mechanism_for(cfg).accountant()
    acc.advance(6, q=0.4)
    assert res.accountant.releases == [6, 6, 6]
    assert res.accountant.epsilon() == acc.epsilon()
    assert res.accountant.amplified_epsilon() == acc.amplified_epsilon()
    assert res.accountant.per_server_epsilon() == [acc.epsilon()] * 3


# -------------------------------------------------------- the sync limit --


@pytest.mark.parametrize("scheme", ["none", "iid_dp", "hybrid"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_sync_limit_is_run_gfl_population(problem, scheme, use_kernels):
    """THE anchor: buffer = L, zero latency, max_stale = 0 is the
    population engine's pure path, bitwise (tolerance: none)."""
    cfg = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=3,
                    privacy=scheme, sigma_g=0.3, mu=0.1, topology="ring",
                    grad_bound=10.0, async_spec="async:buffer=3",
                    use_kernels=use_kernels)
    res_a = run_gfl_async(problem, cfg, ticks=6, batch_size=5, seed=3)
    res_p = run_gfl_population(problem, cfg, iters=6, batch_size=5, seed=3)
    assert res_a.msd.tolist() == res_p.msd.tolist()
    assert torch.equal(res_a.params, res_p.params)
    assert res_a.flushed.all() and res_a.flushed.shape == (6, P)
    np.testing.assert_array_equal(res_a.q, 3 / K)
    assert (res_a.staleness == 0).all() and (res_a.dropped_stale == 0).all()
    assert (res_a.events == 3).all()


def test_sync_limit_full_participation(problem):
    cfg = GFLConfig(num_servers=P, clients_per_server=K, privacy="hybrid",
                    sigma_g=0.3, topology="ring",
                    async_spec=f"async:buffer={K}")
    res_a = run_gfl_async(problem, cfg, ticks=5, batch_size=5, seed=7)
    res_p = run_gfl_population(problem, cfg, iters=5, batch_size=5, seed=7)
    assert res_a.msd.tolist() == res_p.msd.tolist()
    assert torch.equal(res_a.params, res_p.params)
    np.testing.assert_array_equal(res_a.q, 1.0)


def test_sync_limit_under_link_faults(problem):
    """links: faults compose with the lockstep path (the resilient pure
    step), gaps included."""
    cfg = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=4,
                    privacy="hybrid", sigma_g=0.3, topology="ring",
                    fault="links:0.3", topology_seed=2,
                    async_spec="async:buffer=4")
    res_a = run_gfl_async(problem, cfg, ticks=5, batch_size=5, seed=1)
    res_p = run_gfl_population(problem, cfg, iters=5, batch_size=5, seed=1)
    assert res_a.msd.tolist() == res_p.msd.tolist()
    assert torch.equal(res_a.params, res_p.params)
    assert np.array_equal(res_a.gaps, res_p.gaps)


# ----------------------------- ticks against the reference, draws replayed --


def _ref_is_cohort(kb, probs, Kc, Nc, E, B):
    """The reference tick's with-replacement importance draw."""
    Pc = probs.shape[0]
    kc, kb2 = jax.random.split(kb)
    idx = jax.vmap(lambda k, p: jax.random.choice(k, Kc, (E,), replace=True,
                                                  p=p)
                   )(jax.random.split(kc, Pc), probs)
    bidx = jax.vmap(lambda k: jax.random.choice(k, Nc, (B,), replace=False)
                    )(jax.random.split(kb2, Pc * E)).reshape(Pc, E, B)
    return idx, bidx


_ref_is_cohort_jit = jax.jit(_ref_is_cohort, static_argnums=(2, 3, 4, 5))


def async_run_draws(rcfg, *, ticks, batch_size, seed, D, probs=None):
    """Every draw of the reference's tick path (``_run_async_impl`` and
    ``_make_event_tick``), tick by tick: the cohort from ``kb`` (uniform,
    or importance with replacement from ``probs``) and the privacy draws
    of ``split(state.key)`` — one key a server and the combine key, drawn
    on every tick (the port combines every tick and keeps the old params
    where the reference's cond skips)."""
    mech = ref_mechanism_for(rcfg)
    spec = ref_events.parse_async_spec(rcfg.async_spec)
    E = spec.events_per_tick
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    _, state_key = jax.random.split(k_init)             # gfl.init_state
    ticks_out = []
    for t in range(ticks):
        key, kb = jax.random.split(key)
        if probs is None:
            ci, bi = uniform_cohort_indices(kb, P, K, N, E, batch_size)
            entry = ("cohort", "cohort", (np.asarray(ci), np.asarray(bi)))
        else:
            ci, bi = _ref_is_cohort_jit(kb, probs, K, N, E, batch_size)
            entry = ("cohort", "weighted_cohort",
                     (np.asarray(ci), np.asarray(bi)))
        state_key, sub = jax.random.split(state_key)
        key_round, key_combine = jax.random.split(sub)
        ticks_out.append([entry] + round_draws(
            mech, rcfg, key_round, key_combine, t, P, E, D, traced=True,
            combine=True))
    return ticks_out


SCENARIOS = {
    # name: (cohort, async spec, fault)
    "diurnal": ("uniform+trace:diurnal,period=6,min=0.3",
                "async:buffer=10,rate=8", "none"),
    "importance": ("importance,floor=0.2", "async:buffer=12,rate=8",
                   "none"),
    "latency": ("uniform", "async:buffer=10,latency=lognorm:0.7,"
                           "max_stale=3,rate=8", "none"),
    "links": ("uniform+trace:devclass,slow=0.5,p=0.4",
              "async:buffer=12,latency=exp:1.0,max_stale=2,rate=8",
              "links:0.3"),
}
TICKS, B, SEED = 6, 5, 3


def _scenario_cfg(scheme, use_kernels, scenario):
    cohort, async_spec, fault = SCENARIOS[scenario]
    return dict(num_servers=P, clients_per_server=K, privacy=scheme,
                sigma_g=0.3, mu=0.1, topology="ring", grad_bound=5.0,
                cohort=cohort, async_spec=async_spec, fault=fault,
                topology_seed=3, epsilon_target=200.0,
                epsilon_horizon=TICKS, use_kernels=use_kernels)


def _norm_state():
    """A non-uniform importance-sampler state, the same on both sides."""
    rng = np.random.default_rng(5)
    est = rng.uniform(0.05, 4.0, (P, K)).astype(np.float32)
    return est, np.zeros((P, K), np.int32)


def _assert_schedule_equal(got, want):
    assert np.array_equal(got.flushed, np.asarray(want.flushed))
    assert np.array_equal(got.events, np.asarray(want.events))
    assert np.array_equal(got.dropped_stale, np.asarray(want.dropped_stale))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_ticks_with_injected_draws(scheme, use_kernels, scenario,
                                   ref_problem, problem):
    kw = _scenario_cfg(scheme, use_kernels, scenario)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    rsched = tsched = probs = None
    if scenario == "importance":
        est, cnt = _norm_state()
        rsched = types.SimpleNamespace(is_state=ref_IS.ISState(
            jnp.asarray(est), jnp.asarray(cnt)))
        tsched = types.SimpleNamespace(
            is_state=is_state_from_numpy(est, cnt, device="cpu"))
        probs = ref_IS.sampling_probs(rsched.is_state, floor=0.2)
    want = ref_events.run_gfl_async(RefDense.from_problem(ref_problem),
                                    rcfg, ticks=TICKS, batch_size=B,
                                    seed=SEED, scheduler=rsched)
    draws = ReplayDraws(async_run_draws(rcfg, ticks=TICKS, batch_size=B,
                                        seed=SEED, D=M, probs=probs),
                        device="cpu")
    got = run_gfl_async(problem, tcfg, ticks=TICKS, batch_size=B,
                        draws=draws, scheduler=tsched)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.msd, np.asarray(want.msd), atol=1e-5,
                               rtol=0)
    _assert_schedule_equal(got, want)
    np.testing.assert_allclose(got.staleness, np.asarray(want.staleness),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.q, np.asarray(want.q), atol=1e-6, rtol=0)
    if want.gaps is None:
        assert got.gaps is None
    else:
        assert np.array_equal(got.gaps, want.gaps)
    assert got.accountant.per_server_epsilon() == \
        want.accountant.per_server_epsilon()
    assert got.accountant.amplified_epsilon() == pytest.approx(
        want.accountant.amplified_epsilon(), rel=1e-6)
    # the scenarios do what they are for
    if scenario in ("latency", "links"):
        assert got.staleness.max() > 0
    if scenario != "importance":
        assert (got.events < 8).any()


@pytest.mark.parametrize("scenario", ["diurnal", "links"])
def test_ticks_desynchronize_and_flush_subsets(scenario, problem):
    """Thinned arrivals and buffers wider than the tick: some tick flushes
    a strict subset of the servers, q is charged exactly on flushes, and
    the amplified epsilon is the one recomputed from (flushed, q)."""
    cfg = GFLConfig(**_scenario_cfg("hybrid", True, scenario))
    res = run_gfl_async(problem, cfg, ticks=12, batch_size=B, seed=1)
    per_tick = res.flushed.sum(axis=1)
    assert ((per_tick > 0) & (per_tick < P)).any()
    assert (res.q[res.flushed] > 0).all() and (res.q[~res.flushed] == 0).all()
    acc = mechanism_for(cfg).async_accountant(P)
    acc.record_schedule(res.flushed, res.q)
    assert res.accountant.amplified_epsilon() == acc.amplified_epsilon()
    assert np.isfinite(res.msd).all()


@pytest.mark.parametrize("scheme", ["none", "iid_dp", "hybrid"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_loop_is_scan_bitwise(scheme, use_kernels):
    cfg = GFLConfig(num_servers=4, clients_per_server=50, privacy=scheme,
                    sigma_g=0.2, topology="ring",
                    population="synthetic:hetero", fault="links:0.2",
                    cohort="uniform+trace:diurnal,period=8,min=0.3",
                    async_spec="async:buffer=8,latency=lognorm:0.7,"
                               "max_stale=3,rate=6",
                    use_kernels=use_kernels)
    loop = run_gfl_async(None, cfg, ticks=10, batch_size=5, seed=0,
                         device="cpu")
    scan = run_gfl_async(None, cfg, ticks=10, batch_size=5, seed=0,
                         device="cpu", scan=True)
    assert torch.equal(loop.params, scan.params)
    assert loop.msd.tolist() == scan.msd.tolist()
    for field in ("flushed", "q", "staleness", "events", "dropped_stale",
                  "gaps"):
        assert np.array_equal(getattr(loop, field), getattr(scan, field))


def test_sync_limit_scan_takes_the_tick_path(problem):
    """``scan=True`` at the sync limit runs the tick graph (as the
    reference's scan does): every server flushes every tick."""
    cfg = GFLConfig(num_servers=P, clients_per_server=K, clients_sampled=3,
                    privacy="hybrid", sigma_g=0.3, topology="ring",
                    async_spec="async:buffer=3")
    res = run_gfl_async(problem, cfg, ticks=5, batch_size=5, seed=3,
                        scan=True)
    assert res.flushed.all() and (res.events == 3).all()
    np.testing.assert_allclose(res.q, 3 / K, atol=1e-7)
    assert np.isfinite(res.msd).all()


@pytest.mark.parametrize("spec", [
    "async:buffer=6,latency=lognorm:0.8,max_stale=2,rate=5",
    "async:buffer=4,latency=exp:2.0,max_stale=3"])
def test_always_on_schedule_equals_reference_torch_seeded(spec):
    """Under the always-on trace the arrivals depend only on the numpy
    queue, so the flush, event, drop and staleness schedules equal the
    reference's exactly, whatever the cohorts."""
    kw = dict(num_servers=4, clients_per_server=30, privacy="hybrid",
              sigma_g=0.2, topology="ring", population="synthetic:iid",
              async_spec=spec, topology_seed=4)
    got = run_gfl_async(None, GFLConfig(**kw), ticks=15, batch_size=5,
                        seed=2, device="cpu")
    want = ref_events.run_gfl_async(None, RefConfig(**kw), ticks=15,
                                    batch_size=5, seed=2)
    _assert_schedule_equal(got, want)
    assert np.array_equal(got.staleness, np.asarray(want.staleness))
    assert np.array_equal(got.q, np.asarray(want.q))


# ---------------------------------------------- the cohort-weight driver --


@pytest.mark.parametrize("trace", ["always", "devclass,slow=0.5,p=0.3",
                                   "diurnal,period=5,min=0.2"])
@pytest.mark.parametrize("ids", [False, True])
def test_cohort_driver_equals_reference(trace, ids):
    spec = "async:buffer=6,latency=lognorm:0.6,max_stale=3"
    got = AsyncCohortDriver(parse_async_spec(spec), P=3, L=4, K=100,
                            trace=trace, seed=2, device="cpu")
    want = ref_events.AsyncCohortDriver(ref_events.parse_async_spec(spec),
                                        P=3, L=4, K=100, trace=trace, seed=2)
    rng = np.random.default_rng(0)
    releases = 0
    for t in range(20):
        cid = rng.integers(0, 100, (3, 4)) if ids else None
        (gw, gf, gq), (ww, wf, wq) = got.step(t, cid), want.step(t, cid)
        assert gw.dtype == torch.float32 and gw.device.type == "cpu"
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-6,
                                   rtol=0)
        assert np.array_equal(gf, wf) and np.array_equal(gq, wq)
        releases += int(gf.sum())
    assert releases > 0


# ------------------------------------------------------------ refusals --


def test_refusals_equal_reference(problem, ref_problem):
    base = dict(num_servers=P, clients_per_server=K,
                async_spec="async:buffer=4")
    cases = [
        (dict(fault="dropout:0.2"), "dropout"),
        (dict(fault="straggler:0.2,stale=2"), "straggler|dropout"),
        (dict(async_spec="none"), "async spec"),
        (dict(combine_every=2), "combine_every"),
        (dict(async_spec="async:buffer=4,rate=13"), "events per tick"),
    ]
    for over, match in cases:
        kw = {**base, **over}
        with pytest.raises(ValueError, match=match):
            run_gfl_async(problem, GFLConfig(**kw), ticks=2)
        with pytest.raises(ValueError, match=match):
            ref_events.run_gfl_async(ref_problem, RefConfig(**kw), ticks=2)


@pytest.mark.parametrize("field,value", [("telemetry", "memory"),
                                         ("sanitize", True)])
def test_slice_5_options_raise(field, value, problem, tmp_path,
                               monkeypatch):
    """Slice 5's options, which raised before the cross-cutting slice, now
    run: bitwise the run without them."""
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path))
    cfg = GFLConfig(**{"async_spec": "async:buffer=4"})
    got = run_gfl_async(problem, dataclasses.replace(cfg, **{field: value}),
                        ticks=2)
    want = run_gfl_async(problem, cfg, ticks=2)
    assert torch.equal(got.params, want.params)
    assert got.msd.tolist() == want.msd.tolist()


def test_unsafe_mechanism_refused_under_arrivals(problem):
    from repro_torch.core.privacy.mechanism import (
        _REGISTRY, NoiseProfile, PrivacyMechanism, register_mechanism)
    name = "_test_unsafe_events_torch"

    @register_mechanism(name)
    class UnsafeMasks(PrivacyMechanism):
        def noise_profile(self):
            return NoiseProfile(distribution="laplace", client_sigma=1.0,
                                server_sigma=0.0,
                                client_cancels_exactly=True,
                                server_cancels_exactly=True,
                                client_dropout_safe=False)
    try:
        cfg = GFLConfig(num_servers=P, clients_per_server=K, privacy=name,
                        async_spec="async:buffer=4,latency=exp:1,"
                                   "max_stale=2")
        with pytest.raises(ValueError, match="client_dropout_safe"):
            run_gfl_async(problem, cfg, ticks=1)
    finally:
        del _REGISTRY[name]


def test_graph_executor_needs_a_card(problem):
    cfg = GFLConfig(num_servers=P, clients_per_server=K,
                    async_spec="async:buffer=4,rate=2")
    with pytest.raises(ValueError, match="CUDA device"):
        run_gfl_async(problem, cfg, ticks=1, executor="graph")


def test_staged_tick_state_view(problem):
    """The tick's state is the step's in-place buffers: after a run the
    counter is the tick count and the ring's newest slot is the params."""
    from repro_torch.core.population import graphed
    from repro_torch.core.simulate import make_grad_fn
    from repro_torch.draws import Draws
    cfg = GFLConfig(num_servers=P, clients_per_server=K, privacy="none",
                    topology="ring",
                    async_spec="async:buffer=6,latency=fixed:1,max_stale=2,"
                               "rate=4")
    spec = parse_async_spec(cfg.async_spec)
    from repro_torch.core.population.engine import as_population
    from repro_torch.core.simulate import base_combination_matrix
    pop = as_population(problem)
    step = engine.StagedEventTick(
        pop, cfg, spec, parse_trace_spec("always"), None, None,
        base_combination_matrix(cfg, P), make_grad_fn(pop.rho), 5, 7, "cpu",
        seed=0)
    graphed.run_rounds(step, None, Draws(0, "cpu"), 7, pop.w_ref,
                       capture=False)
    st_ = step.state
    assert int(st_.step) == 7 and st_.hist.shape == (3, P, M)
    assert torch.equal(st_.hist[7 % 3], st_.params)
    assert int(st_.buffers.version.sum()) == int(step.flushed.sum())
