"""The port's population engine (lazy populations, cohort scheduling, the
weighted path) against ``repro.core.population``, on the CPU at small
sizes.

Tolerances: spec parsing and ``to_spec`` equal to the reference's, with the
same rejections; availability and dropout realizations and Dirichlet index
tables exactly equal (numpy on both sides); Dirichlet gathers exactly equal
(indexing); the synthetic population's hash bits are integer math (exact)
and its floats are a pure function of the client (bitwise over any cohort);
weighted rounds with the reference's draws replayed (its client and batch
indices and its privacy draws, from its key schedule): final params within
atol 1e-5 after 6 rounds, the MSD trace within rtol 1e-5 (atol 1e-7), the IS
estimates and q within atol 1e-6, counts and gaps exactly; the staged rounds
(what the round graph captures) bitwise the eager executor;
``estimate_w_ref`` on the full client set within atol 1e-5 of the
reference's; the accountant's amplified epsilon equal to the one recomputed
from the run's q trace.

K2's mask mode under dropout folds the survivors' streams with non-uniform
weights; the reference's Pallas path numbers pairs by L padded to 8 (ROADMAP
queue 3), so those runs are held against its ``REPRO_KERNEL_BACKEND=ref``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.configs.base import GFLConfig as RefConfig
from repro.core.population import cohort as ref_cohort
from repro.core.population import population as ref_population
from repro.core.population.engine import estimate_w_ref as ref_estimate
from repro.core.population.engine import run_gfl_population as ref_run_pop
from repro.core.privacy.mechanism import mechanism_for as ref_mechanism_for
from repro.core.simulate import generate_problem as ref_generate
from repro.core.topology import combination_matrix
from repro.data import partition as ref_partition
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import (
    dirichlet_population_from_numpy,
    is_state_from_numpy,
    problem_from_numpy,
)
from repro_torch.core import sampling as IS
from repro_torch.core.population import (
    AvailabilityTrace,
    CohortScheduler,
    DensePopulation,
    DirichletPopulation,
    PopulationSpec,
    SyntheticPopulation,
    cohort_to_spec,
    engine,
    estimate_w_ref,
    parse_cohort_spec,
    parse_population_spec,
    parse_trace_spec,
    population_from_spec,
    population_to_spec,
    run_gfl_population,
)
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.resilience import TopologyProcess
from repro_torch.core.simulate import (
    base_combination_matrix,
    make_grad_fn,
    run_gfl_importance,
)
from repro_torch.data import partition
from repro_torch.draws import Draws, ReplayDraws

from test_torch_parity import round_draws

P, K, N, M = 4, 8, 20, 2
SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
COHORTS = {"importance": "importance,floor=0.2",
           "trace": "uniform+trace:diurnal,period=6,min=0.3"}


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


POP_SPECS = ["dense", "synthetic", "synthetic:iid,sigma=1.0",
             "synthetic:hetero,lo=0.5,hi=1.5,n=40",
             "synthetic:mixture,clusters=8,drift=0.25,dim=3",
             "dirichlet:0.3", "dirichlet:0.3,pool=4000",
             "dirichlet,alpha=2", "synthetic:iid,rho=1e-3"]
POP_BAD = ["synthetic:what", "dense:x", "nope", "synthetic:iid,x",
           "synthetic:iid,sigma=abc", "synthetic:hetero,clusters=3",
           "dirichlet:0.3,lo=1"]


@pytest.mark.parametrize("spec", POP_SPECS)
def test_population_spec_equals_reference(spec):
    got = parse_population_spec(spec)
    want = ref_population.parse_population_spec(spec)
    assert (got.kind, got.args) == (want.kind, want.args)
    text = population_to_spec(got)
    assert text == ref_population.population_to_spec(want)
    assert parse_population_spec(text) == got


@pytest.mark.parametrize("bad", POP_BAD)
def test_population_spec_rejections_equal_reference(bad):
    with pytest.raises(ValueError):
        parse_population_spec(bad)
    with pytest.raises(ValueError):
        ref_population.parse_population_spec(bad)
    with pytest.raises(ValueError):
        PopulationSpec("galaxy")


@given(kind=st.sampled_from(["iid", "hetero", "mixture", "dirichlet"]),
       vals=st.lists(st.one_of(st.integers(1, 999),
                               st.floats(0.01, 50.0, allow_nan=False)),
                     min_size=0, max_size=3))
@settings(max_examples=40, deadline=None)
def test_population_spec_roundtrip_property(kind, vals):
    keys = sorted(ref_population._ALLOWED_KEYS[kind])
    spec = PopulationSpec(kind, dict(zip(keys, vals)))
    text = population_to_spec(spec)
    assert parse_population_spec(text) == spec
    assert text == ref_population.population_to_spec(
        ref_population.PopulationSpec(kind, dict(spec.args)))


TRACE_SPECS = ["always", "diurnal", "diurnal,period=12,min=0.3",
               "devclass", "devclass,slow=0.5,p=0.2"]
COHORT_SPECS = ["uniform", "importance", "importance,floor=0.25",
                "uniform+trace:diurnal,period=6,min=0.1",
                "importance,floor=0.2+trace:devclass,slow=0.4,p=0.3",
                "trace:diurnal+importance"]


@pytest.mark.parametrize("spec", TRACE_SPECS)
def test_trace_spec_and_probs_equal_reference(spec):
    got, want = parse_trace_spec(spec), ref_cohort.parse_trace_spec(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_spec() == want.to_spec()
    assert parse_trace_spec(got.to_spec()) == got
    for i in (0, 5, 23):
        assert np.array_equal(got.probs(i, 97), want.probs(i, 97))


@pytest.mark.parametrize("spec", COHORT_SPECS)
def test_cohort_spec_equals_reference(spec):
    s, f, t = parse_cohort_spec(spec)
    rs, rf, rt = ref_cohort.parse_cohort_spec(spec)
    assert (s, f, dataclasses.asdict(t)) == (rs, rf, dataclasses.asdict(rt))
    text = cohort_to_spec(s, f, t)
    assert text == ref_cohort.cohort_to_spec(rs, rf, rt)
    assert parse_cohort_spec(text) == (s, f, t)


@pytest.mark.parametrize("bad", ["fancy", "uniform,floor=0.1",
                                 "importance,x=1", "trace:nope",
                                 "uniform+trace:diurnal,xyz=1",
                                 "uniform+trace:devclass,period=3"])
def test_cohort_spec_rejections_equal_reference(bad):
    with pytest.raises(ValueError):
        parse_cohort_spec(bad)
    with pytest.raises(ValueError):
        ref_cohort.parse_cohort_spec(bad)
    with pytest.raises(ValueError):
        cohort_to_spec("fancy", 0.1, AvailabilityTrace())


# ---------------------------------------------------- host realizations --


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), round_idx=st.integers(0, 10 ** 6),
       Pn=st.integers(1, 6), Kn=st.integers(1, 300),
       trace=st.sampled_from(TRACE_SPECS[1:]),
       dropout=st.floats(0.0, 1.0))
def test_availability_and_dropout_equal_reference(seed, round_idx, Pn, Kn,
                                                  trace, dropout):
    L = max(1, Kn // 3)
    fault = f"dropout:{dropout:g}"
    got = CohortScheduler(Kn, L, Pn, trace=trace, fault=fault, seed=seed)
    want = ref_cohort.CohortScheduler(Kn, L, Pn, trace=trace, fault=fault,
                                      seed=seed)
    a, b = got.availability(round_idx), want.availability(round_idx)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert a.any(axis=1).all()
    ga, wa = got.client_alive(round_idx), want.client_alive(round_idx)
    assert (ga is None) == (wa is None)
    if ga is not None:
        assert np.array_equal(ga, wa)


def test_scheduler_dropout_matches_topology_process():
    s = CohortScheduler(50, 6, 4, fault="dropout:0.4", seed=13)
    proc = TopologyProcess(combination_matrix("ring", 4), "dropout:0.4",
                           seed=13)
    for i in (0, 3, 17):
        assert np.array_equal(s.client_alive(i), proc.client_alive(i, 6))


def test_scheduler_from_config_and_pure_flag():
    cfg = GFLConfig(num_servers=3, clients_per_server=40, clients_sampled=5,
                    cohort=COHORTS["importance"], fault="dropout:0.2",
                    topology_seed=4)
    s = CohortScheduler.from_config(cfg)
    want = ref_cohort.CohortScheduler.from_config(RefConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name in RefConfig.__dataclass_fields__}))
    assert (s.K, s.L, s.P, s.sampler, s.floor, s.seed) == \
        (want.K, want.L, want.P, want.sampler, want.floor, want.seed)
    assert not s.pure and CohortScheduler(4, 2, 2).pure
    assert s.is_state.norm_est.shape == (3, 40)
    with pytest.raises(ValueError):
        CohortScheduler(4, 5, 2)
    assert CohortScheduler(4, 2, 2).realized_q == 1.0


def test_weighted_selection_respects_availability():
    s = CohortScheduler(30, 4, 2, trace="diurnal,period=8,min=0.1", seed=11,
                        sampler="importance")
    draws = Draws(1, "cpu")
    for i in range(6):
        avail = s.availability(i)
        sel = s.select(draws, i, N=20, batch_size=5)
        assert sel.client_idx.shape == (2, 4) and sel.batch_idx.shape == \
            (2, 4, 5)
        for p in range(2):
            assert avail[p, sel.client_idx[p].numpy()].all()
            assert len(set(sel.batch_idx[p, 0].tolist())) == 5
        assert torch.isfinite(sel.weights).all()
        assert sel.q.dtype == torch.float64 and 0 < float(sel.q) <= 1
        s.observe(sel.client_idx, torch.full((2, 4), 3.0))
    assert int(s.is_state.counts.sum()) == 6 * 2 * 4


def test_observe_updates_in_place():
    s = CohortScheduler(12, 4, 2, sampler="importance")
    est, cnt = s.is_state
    s.observe(torch.tensor([[0, 1, 1, 2], [3, 3, 3, 3]]),
              torch.full((2, 4), 5.0))
    assert s.is_state.norm_est is est and s.is_state.counts is cnt
    assert est[0, 1] == pytest.approx(0.7 + 1.5) and cnt[1, 3] == 4
    np.testing.assert_allclose(
        s.effective_probs(torch.ones((2, 12), dtype=torch.bool))
        .sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_weighted_draw_at_large_k_with_a_mask():
    """K = 10^5 with half the clients unavailable: no unavailable pick,
    and the indices follow the mask in every row."""
    Kn, L = 100_000, 20
    s = CohortScheduler(Kn, L, 3, sampler="importance",
                        trace="devclass,slow=0.5,p=0.1", seed=2)
    draws = Draws(0, "cpu")
    avail = torch.from_numpy(s.availability(0))
    sel = s.weighted(draws, 0, avail, None, N=100, batch_size=10)
    assert avail.gather(1, sel.client_idx).all()
    assert int(sel.client_idx.max()) < Kn


# ------------------------------------------------------------- populations --


def _mem_peak_bytes(fn):
    """The largest CPU allocation an op made while ``fn`` ran."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    return out, max(e.cpu_memory_usage for e in prof.events())


@pytest.mark.parametrize("mode", ["iid", "hetero", "mixture"])
def test_synthetic_gather_is_a_pure_function_of_the_client(mode):
    pop = SyntheticPopulation(3, 10_000, mode=mode, N=40, M=3, data_seed=5,
                              device="cpu")
    h1, g1 = pop.client_shard(1, 9_999)
    h2, g2 = pop.client_shard(1, 9_999)
    assert torch.equal(h1, h2) and torch.equal(g1, g2)
    assert h1.shape == (40, 3) and h1.dtype == torch.float32
    assert not torch.equal(h1, pop.client_shard(1, 9_998)[0])
    assert not torch.equal(h1, pop.client_shard(2, 9_999)[0])
    assert not any(hasattr(pop, a) for a in ("features", "labels"))
    # any cohort, any order, any batch: the rows of the client's shard
    idx = torch.tensor([[0, 42], [9_999, 17], [123, 4_567]])
    bidx = torch.tensor([[[4, 0, 39]] * 2, [[7, 1, 2], [0, 1, 2]],
                         [[5, 6, 7]] * 2])
    h, g = pop.gather(idx, bidx)
    assert h.shape == (3, 2, 3, 3) and g.shape == (3, 2, 3)
    assert torch.equal(h[1, 0], h1[[7, 1, 2]])
    assert torch.equal(g[1, 0], g1[[7, 1, 2]])
    hs, gs = pop.gather(idx.flip(1), bidx.flip(1))
    assert torch.equal(hs, h.flip(1)) and torch.equal(gs, g.flip(1))
    alone, _ = pop.gather(torch.tensor([[0], [9_999], [0]]),
                          torch.tensor([[[7, 1, 2]]] * 3))
    assert torch.equal(alone[1, 0], h1[[7, 1, 2]])
    # another seed is another population
    other = SyntheticPopulation(3, 10_000, mode=mode, N=40, M=3,
                                data_seed=6, device="cpu")
    assert not torch.equal(other.client_shard(1, 9_999)[0], h1)


def test_synthetic_moments_per_mode():
    """Labels are fair coins, features N(gamma m_k, sigma_k^2 I): iid has
    one sigma, hetero spreads sigma over [lo, hi], mixture's clients of a
    cluster share their mean and clusters differ."""
    def stats(pop, k):
        h, g = pop.client_shard(0, k)
        return (float((h - g[:, None] * pop._client_mean(torch.tensor(k))
                       .float()).std()), float(g.mean()))

    iid = SyntheticPopulation(1, 50, mode="iid", sigma=1.0, N=2000,
                              device="cpu")
    het = SyntheticPopulation(1, 50, mode="hetero", lo=0.5, hi=1.5, N=2000,
                              device="cpu")
    iid_s = [stats(iid, k) for k in range(12)]
    het_s = [stats(het, k) for k in range(12)]
    assert all(abs(s - 1.0) < 0.06 and abs(m) < 0.08 for s, m in iid_s)
    assert np.std([s for s, _ in het_s]) > 5 * np.std([s for s, _ in iid_s])
    assert all(0.45 < s < 1.55 for s, _ in het_s)
    mix = SyntheticPopulation(1, 100, mode="mixture", clusters=4, drift=1.0,
                              N=400, device="cpu")
    m = mix._client_mean(torch.arange(8))
    assert torch.equal(m[0], m[4]) and torch.equal(m[1], m[5])
    assert float((m[0] - m[1]).abs().max()) > 1e-3
    h, g = mix.client_shard(0, 5)
    np.testing.assert_allclose((h * g[:, None]).mean(0).numpy(),
                               m[5].numpy(), atol=0.15)


def test_synthetic_gather_at_a_billion_clients_allocates_the_cohort():
    pop = SyntheticPopulation(4, 10 ** 9, mode="hetero", N=100,
                              device="cpu")
    idx = torch.tensor([[10 ** 9 - 1, 0], [5, 77], [123_456_789, 1],
                        [2, 3]])
    bidx = torch.randint(0, 100, (4, 2, 10),
                         generator=torch.Generator().manual_seed(0))
    (h, g), peak = _mem_peak_bytes(lambda: pop.gather(idx, bidx))
    assert h.shape == (4, 2, 10, 2) and torch.isfinite(h).all()
    # [P, L, B, M] float64 intermediates at most; nothing of size K or N
    assert peak <= 4 * 2 * 10 * 2 * 8


def test_population_from_spec_and_as_population(problem):
    cfg = GFLConfig(num_servers=2, clients_per_server=7,
                    population="synthetic:iid,n=20,dim=3", data_seed=3)
    pop = population_from_spec(cfg, device="cpu")
    assert isinstance(pop, SyntheticPopulation)
    assert (pop.P, pop.num_clients, pop.samples_per_client, pop.dim,
            pop.data_seed) == (2, 7, 20, 3, 3)
    assert engine.as_population(None, cfg, "cpu").dim == 3
    assert isinstance(engine.as_population(problem), DensePopulation)
    assert engine.as_population(pop) is pop
    with pytest.raises(ValueError):
        population_from_spec(GFLConfig(population="dense"), device="cpu")
    with pytest.raises(TypeError):
        engine.as_population(object())
    d = population_from_spec(GFLConfig(num_servers=2, clients_per_server=5,
                                       population="dirichlet:0.5,pool=300"),
                             device="cpu")
    assert isinstance(d, DirichletPopulation) and d.index.shape[:2] == (2, 5)


def _pool(n=600, seed=1):
    rng = np.random.default_rng(seed)
    g = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    h = (g[:, None] + rng.standard_normal((n, M))).astype(np.float32)
    return h, g


@pytest.mark.parametrize("alpha,Nn", [(0.2, 0), (1.0, 12), (50.0, 0)])
def test_dirichlet_index_table_and_gather_equal_reference(alpha, Nn):
    h, g = _pool()
    want = ref_population.DirichletPopulation(jnp.asarray(h), jnp.asarray(g),
                                              3, 8, alpha=alpha, N=Nn,
                                              data_seed=4)
    got = DirichletPopulation(torch.tensor(h), torch.tensor(g), 3, 8,
                              alpha=alpha, N=Nn, data_seed=4)
    assert np.array_equal(got.index.numpy(), np.asarray(want.index))
    assert got.samples_per_client == want.samples_per_client
    rng = np.random.default_rng(0)
    ci = rng.integers(0, 8, (3, 5))
    bi = rng.integers(0, got.samples_per_client, (3, 5, 4))
    gh, gg = got.gather(torch.tensor(ci), torch.tensor(bi))
    wh, wg = want.gather(jnp.asarray(ci), jnp.asarray(bi))
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    assert np.array_equal(gg.numpy(), np.asarray(wg))
    again = dirichlet_population_from_numpy(h, g, np.asarray(want.index),
                                            alpha=alpha, device="cpu")
    assert torch.equal(again.index, got.index)
    assert torch.equal(again.gather(torch.tensor(ci), torch.tensor(bi))[0],
                       gh)


def test_dirichlet_synthetic_pool_is_seeded():
    a = DirichletPopulation.synthetic_pool(3, 8, alpha=0.2, pool=600,
                                           data_seed=1, device="cpu")
    b = DirichletPopulation.synthetic_pool(3, 8, alpha=0.2, pool=600,
                                           data_seed=1, device="cpu")
    assert torch.equal(a.pool_h, b.pool_h) and torch.equal(a.index, b.index)
    # the split of that pool is the reference's split of the same labels
    want = ref_population.DirichletPopulation(
        jnp.asarray(a.pool_h.numpy()), jnp.asarray(a.pool_g.numpy()), 3, 8,
        alpha=0.2, data_seed=1)
    assert np.array_equal(a.index.numpy(), np.asarray(want.index))


@pytest.mark.parametrize("seed", range(3))
def test_partition_copy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, size=333)
    got = partition.dirichlet_partition(labels, 3, 5, alpha=0.3, seed=seed,
                                        min_per_client=2)
    want = ref_partition.dirichlet_partition(labels, 3, 5, alpha=0.3,
                                             seed=seed, min_per_client=2)
    for p in range(3):
        for k in range(5):
            assert np.array_equal(got[p][k], want[p][k])
    assert np.array_equal(partition.uniform_partition(100, 2, 3, seed),
                          ref_partition.uniform_partition(100, 2, 3, seed))


def test_estimate_w_ref_on_every_client_equals_reference(problem,
                                                          ref_problem):
    got = estimate_w_ref(DensePopulation.from_problem(problem),
                         sample_clients=K, iters=3000)
    want = ref_estimate(ref_population.DensePopulation.from_problem(
        ref_problem), sample_clients=K, iters=3000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), problem.w_opt.numpy(), atol=1e-3)


def test_estimate_w_ref_subsample_is_seeded():
    pop = SyntheticPopulation(2, 10 ** 6, N=30, device="cpu")
    a = estimate_w_ref(pop, sample_clients=16, seed=3, iters=200)
    b = estimate_w_ref(pop, sample_clients=16, seed=3, iters=200)
    c = estimate_w_ref(pop, sample_clients=16, seed=4, iters=200)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_is_state_from_numpy():
    est = np.arange(6, dtype=np.float32).reshape(2, 3)
    cnt = np.arange(6, dtype=np.int32).reshape(2, 3)
    s = is_state_from_numpy(est, cnt, device="cpu")
    assert isinstance(s, IS.ISState) and s.counts.dtype == torch.int32
    assert np.array_equal(s.norm_est.numpy(), est)
    with pytest.raises(ValueError):
        is_state_from_numpy(est, cnt[:, :2], device="cpu")


# ---------------------------------------- weighted rounds, draws replayed --


class _Recording(ref_cohort.CohortScheduler):
    """The reference's scheduler, keeping each round's drawn clients."""

    def select(self, key, round_idx):
        sel = super().select(key, round_idx)
        self.__dict__.setdefault("picked", []).append(
            np.asarray(sel.client_idx))
        return sel


def weighted_run_draws(rcfg, sched, P_, N_, D, *, iters, batch_size, seed):
    """Every draw of the reference's weighted loop (``_run_population_impl``
    and ``_make_weighted_round``), round by round: its clients (recorded),
    its minibatch indices from ``k_batch`` and the privacy draws of
    ``k_priv`` (one key a server) and ``k_comb``."""
    mech = ref_mechanism_for(rcfg)
    L = sched.L
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    rounds = []
    for i in range(iters):
        key, sub = jax.random.split(key)
        _, k_round = jax.random.split(sub)
        k_batch, k_priv, k_comb = jax.random.split(k_round, 3)
        bidx = jax.vmap(lambda k: jax.random.choice(
            k, N_, (batch_size,), replace=False))(
            jax.random.split(k_batch, P_ * L)).reshape(P_, L, batch_size)
        tau = rcfg.combine_every
        rounds.append([("cohort", "weighted_cohort",
                        (sched.picked[i], np.asarray(bidx)))]
                      + round_draws(mech, rcfg, k_priv, k_comb, i, P_, L, D,
                                    traced=True,
                                    combine=tau <= 1 or i % tau == tau - 1))
    return rounds


def _kw(scheme, cohort, fault="none", iters=6, **kw):
    base = dict(num_servers=P, clients_per_server=K, clients_sampled=5,
                privacy=scheme, sigma_g=0.3, mu=0.1, topology="ring",
                grad_bound=5.0, fault=fault, topology_seed=3,
                cohort=COHORTS[cohort], epsilon_target=200.0,
                epsilon_horizon=iters)
    base.update(kw)
    return base


def _ref_weighted(ref_pop, rcfg, iters, B, seed, backend, monkeypatch):
    sched = _Recording.from_config(rcfg, K=ref_pop.num_clients,
                                   L=rcfg.clients_sampled)
    if backend is not None:
        jax.clear_caches()
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", backend)
    try:
        res = ref_run_pop(ref_pop, rcfg, iters=iters, batch_size=B,
                          seed=seed, scheduler=sched)
    finally:
        if backend is not None:
            monkeypatch.delenv("REPRO_KERNEL_BACKEND")
            jax.clear_caches()
    return res, sched


def _weighted_cases():
    for scheme in SCHEMES:
        for use_kernels in (False, True):
            for cohort in COHORTS:
                yield scheme, use_kernels, cohort, "none", 1
    for scheme in ("none", "iid_dp", "hybrid"):
        for use_kernels in (False, True):
            yield scheme, use_kernels, "importance", "dropout:0.3", 1
            yield scheme, use_kernels, "trace", "links:0.3+dropout:0.3", 1
    for scheme in ("iid_dp", "hybrid"):
        for use_kernels in (False, True):
            yield scheme, use_kernels, "importance", "links:0.3", 2


def _assert_like_reference(got, want, want_sched):
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.msd, np.asarray(want.msd), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.q, np.asarray(want.q), atol=1e-6, rtol=0)
    if want_sched.is_state is not None:
        np.testing.assert_allclose(got.scheduler.is_state.norm_est.numpy(),
                                   np.asarray(want_sched.is_state.norm_est),
                                   atol=1e-6, rtol=0)
        assert np.array_equal(got.scheduler.is_state.counts.numpy(),
                              np.asarray(want_sched.is_state.counts))
    if want.gaps is None:
        assert got.gaps is None
    else:
        assert np.array_equal(got.gaps, want.gaps)
    assert got.staleness is None


@pytest.mark.parametrize("scheme,use_kernels,cohort,fault,tau",
                         list(_weighted_cases()))
def test_weighted_rounds_with_injected_draws(scheme, use_kernels, cohort,
                                             fault, tau, ref_problem,
                                             problem, monkeypatch):
    iters, B, seed = 6, 5, 3
    kw = _kw(scheme, cohort, fault, iters, use_kernels=use_kernels,
             combine_every=tau)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    mask_dropout = (use_kernels and "dropout" in fault
                    and scheme in ("hybrid", "gaussian_dp"))
    ref_pop = ref_population.DensePopulation.from_problem(ref_problem)
    want, sched = _ref_weighted(ref_pop, rcfg, iters, B, seed,
                                "ref" if mask_dropout else None, monkeypatch)
    draws = ReplayDraws(weighted_run_draws(rcfg, sched, P, N, M,
                                           iters=iters, batch_size=B,
                                           seed=seed), device="cpu")
    got = run_gfl_population(problem, tcfg, iters=iters, batch_size=B,
                             draws=draws)
    assert draws.remaining == 0
    _assert_like_reference(got, want, sched)


def test_weighted_rounds_over_a_dirichlet_population(monkeypatch):
    h, g = _pool(800, seed=2)
    kw = _kw("hybrid", "importance", "dropout:0.3", 6, use_kernels=True,
             clients_per_server=10)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    ref_pop = ref_population.DirichletPopulation(
        jnp.asarray(h), jnp.asarray(g), P, 10, alpha=0.3, data_seed=2)
    pop = DirichletPopulation(torch.tensor(h), torch.tensor(g), P, 10,
                              alpha=0.3, data_seed=2)
    w_ref = np.asarray([0.5, 0.4], np.float32)
    sched = _Recording.from_config(rcfg, K=10, L=5)
    jax.clear_caches()
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    try:
        want = ref_run_pop(ref_pop, rcfg, iters=6, batch_size=4, seed=1,
                           scheduler=sched, w_ref=jnp.asarray(w_ref))
    finally:
        monkeypatch.delenv("REPRO_KERNEL_BACKEND")
        jax.clear_caches()
    draws = ReplayDraws(weighted_run_draws(
        rcfg, sched, P, pop.samples_per_client, M, iters=6, batch_size=4,
        seed=1), device="cpu")
    got = run_gfl_population(pop, tcfg, iters=6, batch_size=4, draws=draws,
                             w_ref=torch.tensor(w_ref))
    assert draws.remaining == 0
    _assert_like_reference(got, want, sched)


def test_run_gfl_importance_with_injected_draws(ref_problem, problem):
    from repro.core.simulate import run_gfl_importance as ref_importance
    kw = _kw("none", "importance", "none", 5)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    msd_w, params_w = ref_importance(ref_problem, rcfg, iters=5,
                                     batch_size=4, seed=2)
    sched = _Recording.from_config(dataclasses.replace(
        rcfg, cohort="importance"), K=K, L=5)
    ref_run_pop(ref_problem, dataclasses.replace(rcfg, cohort="importance"),
                iters=5, batch_size=4, seed=2, scheduler=sched)
    draws = ReplayDraws(weighted_run_draws(rcfg, sched, P, N, M, iters=5,
                                           batch_size=4, seed=2),
                        device="cpu")
    msd, params = run_gfl_importance(problem, tcfg, iters=5, batch_size=4,
                                     draws=draws)
    np.testing.assert_allclose(params.numpy(), np.asarray(params_w),
                               atol=1e-5)
    np.testing.assert_allclose(msd, np.asarray(msd_w), rtol=1e-5, atol=1e-7)


# ------------------------------------------ staged rounds, the graph body --


def _plain_weighted_loop(pop, cfg, iters, seed, B=5):
    """The weighted rounds composed op by op from the scheduler's
    ``select`` (the reference's API: availability and dropout realized and
    moved to the device inside it) and ``engine._weighted_round``, fresh
    tensors every round: what the staged body and its buffers must equal."""
    from repro_torch.core import gfl
    from repro_torch.core.privacy.mechanism import RoundContext

    A = base_combination_matrix(cfg, pop.P)
    proc = (None if cfg.fault == "none" else
            TopologyProcess(A, cfg.fault, seed=cfg.topology_seed))
    sched = CohortScheduler.from_config(cfg, K=pop.num_clients)
    mech = mechanism_for(cfg)
    w_ref = estimate_w_ref(pop)
    draws = Draws(seed, "cpu")
    params = gfl.init_state(pop.P, pop.dim).params
    msd, q = [], []
    for i in range(iters):
        sel = sched.select(draws, i, N=pop.samples_per_client, batch_size=B)
        A_i = torch.from_numpy(
            (A if proc is None else proc.realize(i).A).astype(np.float32))
        params, norms = engine._weighted_round(
            params, sel, A_i, draws, RoundContext(step=i, traced_step=True),
            gfl.combines(cfg, i), pop=pop, cfg=cfg, mech=mech,
            grad_fn=make_grad_fn(pop.rho),
            use_alive=sched.fault.client_dropout > 0)
        sched.observe(sel.client_idx, norms)
        msd.append(float(((gfl.centroid(params) - w_ref) ** 2).sum()))
        q.append(float(sel.q))
    return msd, params, q, sched


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cohort,fault,tau", [
    ("importance", "none", 1), ("trace", "links:0.2+dropout:0.3", 2),
    ("importance", "dropout:0.3", 1)])
def test_staged_weighted_rounds_are_the_plain_loop(scheme, use_kernels,
                                                   cohort, fault, tau):
    """The eager executor (``StagedWeightedStep``'s stage and body, the
    round graph's rounds run op by op) bitwise equal to the same rounds
    composed by hand (tolerance: none)."""
    cfg = GFLConfig(**_kw(scheme, cohort, fault, 7, use_kernels=use_kernels,
                          combine_every=tau, clients_per_server=60,
                          population="synthetic:mixture,clusters=3"))
    pop = engine.as_population(None, cfg, "cpu")
    got = run_gfl_population(pop, cfg, iters=7, batch_size=5, seed=2)
    msd, params, q, sched = _plain_weighted_loop(pop, cfg, 7, 2)
    assert torch.equal(got.params, params)
    assert got.msd.tolist() == np.float32(msd).tolist()
    assert got.q.tolist() == q
    if sched.is_state is not None:
        assert torch.equal(got.scheduler.is_state.norm_est,
                           sched.is_state.norm_est)
        assert torch.equal(got.scheduler.is_state.counts,
                           sched.is_state.counts)
    assert (got.gaps is None) == (fault == "none")


# --------------------------------------------------- engine behaviour --


def test_weighted_engine_runs_with_everything_on():
    cfg = GFLConfig(num_servers=4, clients_per_server=50, clients_sampled=5,
                    privacy="iid_dp", sigma_g=0.1, mu=0.1, topology="ring",
                    population="synthetic:mixture,clusters=3,drift=0.7",
                    cohort="importance,floor=0.2+trace:diurnal,period=12,"
                           "min=0.3",
                    fault="links:0.2+dropout:0.3", use_kernels=True)
    res = run_gfl_population(None, cfg, iters=6, batch_size=5, seed=0,
                             device="cpu")
    assert np.isfinite(res.msd).all() and res.msd.shape == (6,)
    assert res.q.shape == (6,) and ((res.q > 0) & (res.q <= 1)).all()
    assert res.gaps.shape == (6,) and res.staleness is None
    assert res.scheduler.q_history == res.q.tolist()
    # the accountant was charged at the run's q trace, round by round
    acc = mechanism_for(cfg).accountant()
    for qi in res.q:
        acc.advance(1, q=float(qi))
    assert res.accountant.amplified_epsilon() == acc.amplified_epsilon()
    assert res.accountant.amplified_epsilon() < res.accountant.epsilon()


def test_record_every_keeps_every_nth_round():
    cfg = GFLConfig(**_kw("hybrid", "trace", population="synthetic:iid",
                          clients_per_server=40))
    full = run_gfl_population(None, cfg, iters=6, batch_size=5, seed=1,
                              device="cpu")
    some = run_gfl_population(None, cfg, iters=6, batch_size=5, seed=1,
                              device="cpu", record_every=4)
    assert some.msd.tolist() == full.msd[::4].tolist()
    assert some.q.tolist() == full.q.tolist()


def test_pure_path_over_a_lazy_population_scan_is_the_loop():
    cfg = GFLConfig(num_servers=4, clients_per_server=200,
                    clients_sampled=5, privacy="none", mu=0.1,
                    topology="ring", population="synthetic:hetero")
    loop = run_gfl_population(None, cfg, iters=5, batch_size=5, seed=0,
                              device="cpu")
    scan = run_gfl_population(None, cfg, iters=5, batch_size=5, seed=0,
                              device="cpu", scan=True)
    assert torch.equal(loop.params, scan.params)
    assert loop.msd.tolist() == scan.msd.tolist()
    assert loop.q.tolist() == [5 / 200] * 5


def test_weighted_refusals_raise_value_error(problem, unsafe_mechanism):
    base = dict(num_servers=P, clients_per_server=K, clients_sampled=4,
                privacy="hybrid", sigma_g=0.2, topology="ring")
    cfg = GFLConfig(**base, population="synthetic:iid",
                    cohort="uniform+trace:devclass",
                    fault="straggler:0.3,stale=2")
    with pytest.raises(ValueError, match="straggler"):
        run_gfl_population(None, cfg, iters=2, batch_size=5, seed=0,
                           device="cpu")
    cfg = GFLConfig(**base, cohort="importance")
    with pytest.raises(ValueError, match="scan executor"):
        run_gfl_population(problem, cfg, iters=2, batch_size=5, scan=True)
    cfg = GFLConfig(**dict(base, privacy=unsafe_mechanism),
                    cohort="importance", fault="dropout:0.3")
    with pytest.raises(ValueError, match="client_dropout_safe"):
        run_gfl_population(problem, cfg, iters=1, batch_size=5)


def test_reference_refuses_the_same(ref_problem):
    base = dict(num_servers=P, clients_per_server=K, clients_sampled=4,
                privacy="hybrid", sigma_g=0.2, topology="ring")
    with pytest.raises(ValueError, match="straggler"):
        ref_run_pop(None, RefConfig(**base, population="synthetic:iid",
                                    cohort="uniform+trace:devclass",
                                    fault="straggler:0.3,stale=2"),
                    iters=1, batch_size=5)
    with pytest.raises(ValueError, match="scan executor"):
        ref_run_pop(ref_problem, RefConfig(**base, cohort="importance"),
                    iters=1, batch_size=5, scan=True)


@pytest.fixture
def unsafe_mechanism():
    """A mechanism with client noise that does not declare dropout
    safety, registered for one test and then removed, so no other test
    (``list_mechanisms``) sees it."""
    from repro_torch.core.privacy.mechanism import (
        _REGISTRY, NoiseProfile, PrivacyMechanism, register_mechanism)
    name = "_test_unsafe_population_torch"

    @register_mechanism(name)
    class UnsafeMasks(PrivacyMechanism):
        def noise_profile(self):
            return NoiseProfile(distribution="laplace", client_sigma=1.0,
                                server_sigma=0.0,
                                client_cancels_exactly=True,
                                server_cancels_exactly=True,
                                client_dropout_safe=False)
    yield name
    del _REGISTRY[name]


@pytest.mark.parametrize("field,value,where", [
    ("async_spec", "async", "slice 4"), ("telemetry", "memory", "slice 5"),
    ("sanitize", True, "slice 5")])
def test_later_slices_still_raise(field, value, where, problem, tmp_path,
                                  monkeypatch):
    """The options of later slices are ported now.  Slice 4's
    ``async_spec`` (the event engine reads it) and slice 5's telemetry and
    sanitizer all leave the weighted run bitwise as it is without them;
    the population engine ignores ``async_spec``, as the reference's
    does."""
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path))
    cfg = GFLConfig(**{field: value, "cohort": "importance"})
    cfg = dataclasses.replace(cfg, num_servers=P, clients_per_server=K,
                              clients_sampled=4)
    got = run_gfl_population(problem, cfg, iters=2, batch_size=5)
    want = run_gfl_population(problem, dataclasses.replace(
        cfg, async_spec="none", telemetry="off", sanitize=False), iters=2,
        batch_size=5)
    assert torch.equal(got.params, want.params)
    assert got.msd.tolist() == want.msd.tolist()
