"""The port's resilience runtime against ``repro.core.resilience``, on the
CPU at small sizes.

Tolerances: fault realizations (``fault_stream_rng``,
``client_dropout_mask``, ``TopologyProcess.realize`` / ``client_alive``,
``fold_dropped_links``), gap trajectories and straggler ages exactly
equal; ``fault=none`` bitwise equal to the static path; the survivor mean
on the reference's pair streams within atol 1e-5, and within atol 1e-5 of
the exact survivor mean at mask scale 1; faulted 8-round trajectories with
the reference's draws replayed within params atol 1e-4 and MSD rtol 1e-3,
as the static trajectory tests (``test_torch_gfl.py``).

K2's mask mode under dropout folds the survivors' streams with non-uniform
weights; the reference's Pallas path then numbers pairs by L padded to 8,
its ``ref`` backend and the port by the true L, so those runs are held
against ``REPRO_KERNEL_BACKEND=ref`` at L = 5 and against Pallas at L = 8.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.configs.base import GFLConfig as RefConfig
from repro.core import gfl as ref_gfl
from repro.core.population.engine import run_gfl_population as ref_run_pop
from repro.core.privacy.secure_agg import (
    masked_client_mean_dropout_vec as ref_dropout_mean,
)
from repro.core.resilience import faults as ref_faults
from repro.core.resilience import process as ref_process
from repro.core.simulate import generate_problem as ref_generate
from repro.core.simulate import make_grad_fn as ref_grad_fn
from repro.core.topology import combination_matrix as ref_combination
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import gfl_state_from_numpy, problem_from_numpy
from repro_torch.core import gfl
from repro_torch.core.population import DensePopulation
from repro_torch.core.population.engine import run_gfl_population
from repro_torch.core.privacy.mechanism import (
    _REGISTRY,
    NoiseProfile,
    PrivacyMechanism,
    mechanism_for,
    register_mechanism,
)
from repro_torch.core.privacy.secure_agg import (
    masked_client_mean_dropout_vec,
    num_pairs,
)
from repro_torch.core.resilience import (
    FaultModel,
    ResilientGFLState,
    TopologyProcess,
    ensure_dropout_safe,
    fold_dropped_links,
    init_resilient_state,
    make_resilient_gfl_step,
    parse_fault_spec,
)
from repro_torch.core.resilience import faults
from repro_torch.core.simulate import make_grad_fn, run_gfl
from repro_torch.core.topology import combination_matrix, spectral_gap
from repro_torch.draws import Draws, ReplayDraws

from test_torch_parity import _pair_normals, gfl_round_draws, run_gfl_draws

P, K, N, M = 4, 8, 20, 2
SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
FAMILIES = ("ring", "torus", "full", "erdos", "hypercube", "expander")
SPECS = {"links": "links:0.3", "outage": "outage:0.25",
         "straggler": "straggler:0.4,stale=2", "dropout": "dropout:0.3",
         "all": "links:0.2+outage:0.1+straggler:0.3,stale=2+dropout:0.3"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs here are many small ops, which torch's
    thread pool slows by orders of magnitude when the test run's other
    processes hold the cores."""
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


def _family_P(topology, n):
    if topology == "hypercube":           # needs a power of two
        return 1 << max(n.bit_length() - 1, 2)
    return n


def _kw(fault, scheme="hybrid", iters=8, **kw):
    base = dict(num_servers=P, clients_per_server=K, clients_sampled=5,
                privacy=scheme, sigma_g=0.3, mu=0.1, topology="ring",
                grad_bound=5.0, fault=fault, topology_seed=3,
                epsilon_target=200.0, epsilon_horizon=iters)
    base.update(kw)
    return base


# ------------------------------------------------------------ fault specs --


@settings(max_examples=50, deadline=None)
@given(st.integers(0, 100), st.integers(0, 100), st.integers(0, 100),
       st.integers(1, 6), st.integers(0, 100), st.booleans())
def test_fault_spec_roundtrip(links, outage, straggler, stale, dropout,
                              kill):
    fm = FaultModel(link_drop=links / 100, outage=outage / 100,
                    outage_kill=kill and outage > 0,
                    straggler=straggler / 100, staleness=stale,
                    client_dropout=dropout / 100)
    rt = parse_fault_spec(fm.to_spec())
    if fm.straggler == 0:     # the canonical form drops an idle staleness
        fm = dataclasses.replace(fm, staleness=1)
    assert rt == fm
    assert parse_fault_spec(rt.to_spec()) == rt
    ref = ref_faults.parse_fault_spec(fm.to_spec())
    assert dataclasses.asdict(ref) == dataclasses.asdict(rt)
    assert ref.to_spec() == rt.to_spec()


@pytest.mark.parametrize("bad", [
    "links", "links:xyz", "frobnicate:0.1", "links:0.1+links:0.2",
    "links:1.5", "dropout:-0.1", "straggler:0.1,wat=3",
    "straggler:0.1,stale=0", "outage:0.1,kill=x"])
def test_fault_spec_rejects_garbage(bad):
    with pytest.raises(ValueError):
        parse_fault_spec(bad)
    with pytest.raises(ValueError):
        ref_faults.parse_fault_spec(bad)


def test_fault_spec_null_forms():
    assert parse_fault_spec("none").is_null
    assert parse_fault_spec("links:0.0+dropout:0").is_null
    assert FaultModel().to_spec() == "none"
    assert parse_fault_spec("links:0.1").perturbs_topology
    assert not parse_fault_spec("dropout:0.5").perturbs_topology


# ------------------------------------------------ exact realizations ------


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), round_idx=st.integers(0, 10 ** 6),
       Pn=st.integers(1, 12), L=st.integers(1, 12),
       dropout=st.floats(0.0, 1.0))
def test_fault_stream_and_dropout_mask_equal_reference(seed, round_idx, Pn,
                                                       L, dropout):
    for stream in (faults.STREAM_TOPOLOGY, faults.STREAM_STRAGGLER,
                   faults.STREAM_DROPOUT, faults.STREAM_AVAILABILITY,
                   faults.STREAM_ARRIVAL, faults.STREAM_LATENCY):
        a = faults.fault_stream_rng(seed, stream, round_idx).random(5)
        b = ref_faults.fault_stream_rng(seed, stream, round_idx).random(5)
        assert np.array_equal(a, b)
    got = faults.client_dropout_mask(seed, round_idx, Pn, L, dropout)
    want = ref_faults.client_dropout_mask(seed, round_idx, Pn, L, dropout)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.any(axis=1).all()


def _same_realization(got, want):
    assert np.array_equal(got.A, want.A)
    assert np.array_equal(got.link_mask, want.link_mask)
    assert np.array_equal(got.straggler, want.straggler)
    assert got.gap == want.gap


@pytest.mark.parametrize("topology", FAMILIES)
@pytest.mark.parametrize("spec", ["none", "links:0.3", "outage:0.2",
                                  "links:0.5+outage:0.2",
                                  "straggler:0.5,stale=3+dropout:0.4",
                                  SPECS["all"]])
def test_topology_process_equals_reference(topology, spec):
    n = _family_P(topology, 10)
    A = combination_matrix(topology, n, seed=3)
    assert np.array_equal(A, ref_combination(topology, n, seed=3))
    proc = TopologyProcess(A, spec, seed=5)
    ref = ref_process.TopologyProcess(A, spec, seed=5)
    assert proc.static == ref.static
    for i in range(12):
        real = proc.realize(i)
        _same_realization(real, ref.realize(i))
        np.testing.assert_allclose(real.A, real.A.T, atol=1e-12)
        np.testing.assert_allclose(real.A.sum(0), 1.0, atol=1e-12)
        assert real.gap < 1.0
        assert np.array_equal(proc.client_alive(i, 6),
                              ref.client_alive(i, 6))
    assert np.array_equal(proc.gap_trajectory(12), ref.gap_trajectory(12))


@given(topology=st.sampled_from(FAMILIES), n=st.integers(4, 20),
       drop=st.floats(0.0, 0.7), outage=st.floats(0.0, 0.4),
       straggler=st.floats(0.0, 1.0), round_idx=st.integers(0, 500),
       seed=st.integers(0, 99))
@settings(max_examples=40, deadline=None)
def test_realize_property_equals_reference(topology, n, drop, outage,
                                           straggler, round_idx, seed):
    n = _family_P(topology, n)
    kw = dict(link_drop=drop, outage=outage, straggler=straggler)
    A = combination_matrix(topology, n, seed=seed)
    proc = TopologyProcess(A, FaultModel(**kw), seed=seed, validate=False)
    ref = ref_process.TopologyProcess(A, ref_faults.FaultModel(**kw),
                                      seed=seed, validate=False)
    real = proc.realize(round_idx)
    _same_realization(real, ref.realize(round_idx))
    assert spectral_gap(real.A) < 1.0


def test_fold_dropped_links_exact():
    A = combination_matrix("torus", 9)
    full = ~np.eye(9, dtype=bool)
    assert np.array_equal(fold_dropped_links(A, full), A)
    j, k = map(int, np.argwhere(np.triu(A, 1) > 0)[0])
    mask = full.copy()
    mask[j, k] = mask[k, j] = False
    Ad = fold_dropped_links(A, mask)
    assert Ad[j, k] == 0.0 and Ad[j, j] == A[j, j] + A[j, k]
    rng = np.random.default_rng(0)
    for _ in range(5):
        m = rng.random((9, 9)) < 0.5
        m = m & m.T
        assert np.array_equal(fold_dropped_links(A, m),
                              ref_process.fold_dropped_links(A, m))


# ------------------------------------ dropout-safe secure aggregation -----


@pytest.mark.parametrize("L,scale", [(6, 4.0), (9, 1.0), (2, 2.0)])
def test_dropout_mean_equals_reference_on_its_streams(L, scale):
    key = jax.random.PRNGKey(L)
    D = 16
    upd = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (L, D)))
    alive = np.random.default_rng(L).random(L) < 0.6
    alive[1] = True
    alive[0] = False
    want = ref_dropout_mean(jnp.asarray(upd), key, jnp.asarray(alive), scale)
    normals = torch.tensor(np.asarray(_pair_normals(key, L, D)))
    got = masked_client_mean_dropout_vec(torch.tensor(upd),
                                         torch.tensor(alive), scale,
                                         normals=normals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dropout_mean_is_the_exact_survivor_mean():
    """Batched over servers, on Generator streams: the orphaned streams are
    subtracted, so the result is the survivors' plain mean."""
    gen = torch.Generator().manual_seed(3)
    upd = torch.randn((3, 7, 24), generator=gen)
    alive = torch.rand((3, 7), generator=gen) < 0.5
    alive[:, 0] = True
    normals = torch.randn((3, num_pairs(7), 24), generator=gen)
    got = masked_client_mean_dropout_vec(upd, alive, 1.0, normals=normals)
    for p in range(3):
        np.testing.assert_allclose(got[p].numpy(),
                                   upd[p][alive[p]].mean(0).numpy(),
                                   atol=1e-5)
    # the plain fold that leaves the orphaned streams in does not match
    S = normals.new_zeros((3, 7, 7, 24))
    jj, kk = torch.triu_indices(7, 7, offset=1)
    S[:, jj, kk] = normals
    masks = (S - S.transpose(1, 2)).sum(2)
    leaky = torch.stack([(upd[p] + masks[p])[alive[p]].mean(0)
                         for p in range(3)])
    assert (leaky - got).abs().max() > 1e-2


@pytest.mark.parametrize("scheme", SCHEMES)
def test_masked_hooks_match_reference(scheme):
    """Each mechanism's client_protect_masked on the reference's draws."""
    Pn, L, D = 3, 5, 6
    kw = dict(num_servers=Pn, clients_per_server=L, privacy=scheme,
              sigma_g=0.7, mu=0.1, epsilon_target=0.0)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    rmech, tmech = ref_gfl.mechanism_for(rcfg), mechanism_for(tcfg)
    assert tmech.noise_profile().client_dropout_safe
    rng = np.random.default_rng(7)
    w = rng.standard_normal((Pn, L, D)).astype(np.float32)
    alive = rng.random((Pn, L)) < 0.6
    alive[:, 2] = True
    key = jax.random.PRNGKey(2)
    keys = jax.random.split(key, Pn)
    want = np.stack([np.asarray(rmech.client_protect_masked(
        jnp.asarray(w[p]), keys[p], jnp.asarray(alive[p])))
        for p in range(Pn)])
    entries = []
    if scheme == "iid_dp":
        entries = [("client", "laplace_uniform", np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (L, D), jnp.float32,
                                         minval=-0.5 + 1e-7,
                                         maxval=0.5 - 1e-7))(keys)))]
    elif scheme != "none":
        entries = [("client", "normal", np.asarray(jax.vmap(
            lambda k: _pair_normals(k, L, D))(keys)))]
    draws = ReplayDraws([entries], device="cpu")
    got = tmech.client_protect_masked(torch.tensor(w), draws,
                                      torch.tensor(alive),
                                      gfl.RoundContext(step=0))
    assert draws.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.fixture
def unsafe_mechanism():
    """A mechanism that does not declare dropout safety, registered for
    one test and then removed, so no other test (``list_mechanisms``)
    sees it."""
    name = "_test_unsafe_masks_torch"

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


def test_ensure_dropout_safe_refuses_undeclared(problem, unsafe_mechanism):
    with pytest.raises(ValueError, match="client_dropout_safe"):
        ensure_dropout_safe(NoiseProfile("laplace", 1.0, 1.0, True, True))
    ensure_dropout_safe(NoiseProfile("laplace", 1.0, 1.0, True, True,
                                     client_dropout_safe=True))
    name = unsafe_mechanism
    cfg = GFLConfig(**_kw("dropout:0.3", scheme=name))
    A = combination_matrix("ring", P)
    with pytest.raises(ValueError, match="client_dropout_safe"):
        make_resilient_gfl_step(TopologyProcess(A, cfg.fault),
                                make_grad_fn(problem.rho), cfg)
    with pytest.raises(ValueError, match="client_dropout_safe"):
        run_gfl(problem, cfg, iters=1, batch_size=5)
    batch = (torch.zeros((P, 5, 3, M)), torch.ones((P, 5, 3)))
    with pytest.raises(ValueError, match="client_dropout_safe"):
        gfl.gfl_round(torch.zeros((P, M)), batch, Draws(0, "cpu"),
                      A=TopologyProcess(A, cfg.fault), cfg=cfg,
                      grad_fn=make_grad_fn(problem.rho))
    # without a dropout component the same mechanism runs
    make_resilient_gfl_step(TopologyProcess(A, "links:0.2"),
                            make_grad_fn(problem.rho),
                            GFLConfig(**_kw("links:0.2", scheme=name)))


# --------------------------------------------------- resilient execution --


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("combine_every", [1, 3])
def test_fault_none_bitwise_equal_to_static(scheme, use_kernels,
                                            combine_every, problem):
    """A zero-probability fault model runs the whole runtime (per-round
    A_i buffers, the survivor-weight plumbing) yet reproduces the static
    path bit for bit."""
    kw = dict(iters=7, batch_size=5, seed=11)
    cfg = GFLConfig(**_kw("none", scheme, use_kernels=use_kernels,
                          combine_every=combine_every))
    msd_s, p_s = run_gfl(problem, cfg, **kw)
    msd_r, p_r, gaps = run_gfl(
        problem, dataclasses.replace(cfg, fault="links:0.0+dropout:0.0"),
        record_gaps=True, **kw)
    assert torch.equal(p_s, p_r)
    assert msd_s.tolist() == msd_r.tolist()
    assert np.all(gaps == spectral_gap(combination_matrix("ring", P)))


def _ref_population(ref_problem, rcfg, iters, B, seed, backend,
                    monkeypatch):
    """The reference's run, with its kernels on ``backend``; its jit
    caches are cleared around a backend switch, since the backend is read
    when a call is traced."""
    if backend is None:
        return ref_run_pop(ref_problem, rcfg, iters=iters, batch_size=B,
                           seed=seed)
    jax.clear_caches()
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", backend)
    try:
        return ref_run_pop(ref_problem, rcfg, iters=iters, batch_size=B,
                           seed=seed)
    finally:
        monkeypatch.delenv("REPRO_KERNEL_BACKEND")
        jax.clear_caches()


def _faulted_cases():
    for name in ("links", "outage", "straggler", "dropout", "all"):
        schemes = SCHEMES if name == "all" else ["none", "iid_dp", "hybrid"]
        for scheme in schemes:
            for use_kernels in (False, True):
                yield name, scheme, use_kernels, 5
    yield "dropout", "hybrid", True, 8          # K2 beside Pallas at L = 8
    yield "all", "gaussian_dp", True, 8


@pytest.mark.parametrize("name,scheme,use_kernels,L",
                         list(_faulted_cases()))
def test_faulted_trajectory_with_injected_draws(name, scheme, use_kernels,
                                                L, ref_problem, problem,
                                                monkeypatch):
    iters, B, seed = 8, 5, 3
    kw = _kw(SPECS[name], scheme, iters=iters, use_kernels=use_kernels,
             clients_sampled=L)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    mask_dropout = (use_kernels and "dropout" in SPECS[name]
                    and scheme in ("hybrid", "gaussian_dp") and L % 8)
    want = _ref_population(ref_problem, rcfg, iters, B, seed,
                           "ref" if mask_dropout else None, monkeypatch)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K, N, M, iters=iters,
                                      batch_size=B, seed=seed), device="cpu")
    got = run_gfl_population(problem, tcfg, iters=iters, batch_size=B,
                             draws=draws)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               atol=1e-4)
    np.testing.assert_allclose(got.msd, np.asarray(want.msd), rtol=1e-3)
    assert np.array_equal(got.gaps, want.gaps)
    assert got.staleness.dtype == np.int32
    assert np.array_equal(got.staleness, want.staleness)


def test_gfl_round_under_a_process_equals_reference(ref_problem):
    """One direct gfl_round with a TopologyProcess at a concrete step."""
    L, B, step = 5, 4, 2
    kw = _kw("links:0.4+dropout:0.4", "hybrid")
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    A = combination_matrix("ring", P)
    rng = np.random.default_rng(1)
    params = rng.standard_normal((P, M)).astype(np.float32)
    h = rng.standard_normal((P, L, B, M)).astype(np.float32)
    gam = np.where(rng.random((P, L, B)) < 0.5, 1.0, -1.0).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = ref_gfl.gfl_round(
        jnp.asarray(params), (jnp.asarray(h), jnp.asarray(gam)), key,
        A=ref_process.TopologyProcess(A, rcfg.fault, seed=3),
        grad_fn=ref_grad_fn(0.01), cfg=rcfg, step=step)
    draws = ReplayDraws([[]] * step + [gfl_round_draws(rcfg, key, P, L, M,
                                                       step)], device="cpu")
    got = gfl.gfl_round(gfl_state_from_numpy(params, 0, "cpu").params,
                        (torch.tensor(h), torch.tensor(gam)), draws,
                        A=TopologyProcess(A, tcfg.fault, seed=3),
                        grad_fn=make_grad_fn(0.01), cfg=tcfg, step=step)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_straggler_staleness_bound(problem):
    """Straggler probability 1 with stale=2: ages cycle 1, 2, 0 (a refresh
    forced at the bound) and psi moves only on refresh rounds."""
    cfg = GFLConfig(**_kw("straggler:1.0,stale=2", "none"))
    step = make_resilient_gfl_step(
        TopologyProcess(combination_matrix("ring", P), cfg.fault, seed=0),
        make_grad_fn(problem.rho), cfg)
    state = init_resilient_state(P, M, init_scale=0.5,
                                 generator=torch.Generator().manual_seed(0))
    assert isinstance(state, ResilientGFLState)
    gen = torch.Generator().manual_seed(5)
    batch = (torch.randn((P, 4, 5, M), generator=gen),
             torch.where(torch.rand((P, 4, 5), generator=gen) < 0.5,
                         1.0, -1.0))
    draws = Draws(0, "cpu")
    ages, moved = [], []
    for _ in range(6):
        prev = state.psi_cache.clone()
        state = step(state, batch, draws)
        ages.append(state.psi_age.tolist())
        moved.append(not torch.equal(prev, state.psi_cache))
    assert ages == [[1] * P, [2] * P, [0] * P] * 2
    assert moved == [False, False, True] * 2


@pytest.mark.parametrize("stale", [1, 3])
def test_straggler_ages_never_pass_the_bound(stale, problem):
    cfg = GFLConfig(**_kw(f"straggler:0.6,stale={stale}", "hybrid"))
    res = run_gfl_population(problem, cfg, iters=30, batch_size=5, seed=2)
    assert res.staleness.shape == (30, P)
    assert res.staleness.max() == stale and res.staleness.min() == 0
    # an age only grows by one a round, or resets to 0
    d = np.diff(res.staleness, axis=0)
    assert np.all((d == 1) | (res.staleness[1:] == 0))


def test_step_buffers_keep_their_addresses(problem):
    """A_i, the survivor mask and the straggler mask are written in place:
    every round reads them at the same addresses."""
    cfg = GFLConfig(**_kw(SPECS["all"], "hybrid", use_kernels=True))
    proc = TopologyProcess(combination_matrix("ring", P), cfg.fault, seed=3)
    step = make_resilient_gfl_step(proc, make_grad_fn(problem.rho), cfg)
    seen = []
    orig = gfl._client_updates

    def spy(params, batch, draws, grad_fn, cfg_, mech, ctx, alive=None):
        seen.append((alive.data_ptr(), alive.clone()))
        return orig(params, batch, draws, grad_fn, cfg_, mech, ctx, alive)

    gfl._client_updates = spy
    try:
        state = gfl.init_state(P, M, device="cpu")
        draws = Draws(1, "cpu")
        pop = DensePopulation.from_problem(problem)
        for i in range(4):
            state = step(state, pop.gather(*draws.cohort(i, P, K, N, 5, 3)),
                         draws)
    finally:
        gfl._client_updates = orig
    assert len({ptr for ptr, _ in seen}) == 1
    for i, (_, alive) in enumerate(seen):
        assert np.array_equal(alive.numpy(), proc.client_alive(i, 5))


def test_scan_with_a_process_raises(problem):
    cfg = GFLConfig(**_kw("links:0.2"))
    with pytest.raises(ValueError, match="static-topology"):
        run_gfl_population(problem, cfg, iters=2, batch_size=5, scan=True)


def test_fault_on_the_weighted_path_names_slice_3(problem):
    """Faults on the weighted path (slice 3) run: A_i realized each round
    from cfg.fault, or from an explicit process, with the gaps of its
    trajectory; stragglers there raise as in the reference."""
    cfg = GFLConfig(**_kw("links:0.2", cohort="importance"))
    res = run_gfl_population(problem, cfg, iters=3, batch_size=5)
    ref = ref_process.TopologyProcess(ref_combination("ring", P),
                                      "links:0.2", seed=cfg.topology_seed)
    assert np.array_equal(res.gaps, ref.gap_trajectory(3))
    cfg = GFLConfig(**_kw("none", cohort="importance"))
    proc = TopologyProcess(combination_matrix("ring", P), "links:0.2",
                           seed=0)
    res = run_gfl_population(problem, cfg, iters=3, batch_size=5,
                             process=proc)
    assert np.array_equal(res.gaps, proc.gap_trajectory(3))
    proc = TopologyProcess(combination_matrix("ring", P), "straggler:0.2",
                           seed=0)
    with pytest.raises(ValueError, match="straggler"):
        run_gfl_population(problem, cfg, iters=1, batch_size=5, process=proc)


def test_run_gfl_records_gaps(problem):
    cfg = GFLConfig(**_kw(SPECS["all"]))
    msd, params, gaps = run_gfl(problem, cfg, iters=20, batch_size=5,
                                seed=1, record_gaps=True)
    assert np.isfinite(msd).all() and msd.shape == (20,)
    assert gaps.shape == (20,) and (gaps < 1.0).all()
    ref = ref_process.TopologyProcess(
        ref_combination("ring", P), cfg.fault, seed=cfg.topology_seed)
    assert np.array_equal(gaps, ref.gap_trajectory(20))


# -------------------------------------------------------- entry points ----


def test_fault_sweep_rows_follow_the_reference_shape():
    from repro.core.simulate import fault_sweep as ref_fault_sweep
    from repro_torch.core.simulate import fault_sweep
    ref_prob = ref_generate(jax.random.PRNGKey(1), P=P, K=K, N=N, M=M)
    prob = problem_from_numpy(ref_prob.features, ref_prob.labels,
                              ref_prob.rho, ref_prob.w_opt, device="cpu")
    kw = _kw("none", "hybrid")
    rows = fault_sweep(prob, GFLConfig(**kw), iters=10, drop_probs=(0, 0.3),
                       fault_kind="outage", batch_size=5, seed=1)
    ref_rows = ref_fault_sweep(ref_prob, RefConfig(**kw), iters=10,
                               drop_probs=(0, 0.3), fault_kind="outage",
                               batch_size=5, seed=1)
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    # the gap trajectories are the same realizations, exactly
    assert [r[2:] for r in rows] == [r[2:] for r in ref_rows]
    assert all(np.isfinite(r[1]) for r in rows)


@pytest.mark.parametrize("entry,flags,n_rows", [
    ("fault_sweep", [], 12),
    ("resilience_demo", [], 6)])
def test_entry_prints_its_rows(entry, flags, n_rows, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{entry}")
    mod.main(["--reduced", "--device", "cpu"] + flags)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    header, *rows = list(csv.reader(out[1:2 + n_rows]))
    assert all(len(r) == len(header) for r in rows)
    if entry == "fault_sweep":
        vals = dict(ln.split(",") for ln in out[2 + n_rows:])
        assert 0 < float(vals["fault_sweep/host_realize_share_of_faulted_"
                              "round"]) < 1
        assert float(vals["fault_sweep/wall_ms_per_round/static"]) > 0
    else:
        assert out[-1].startswith("# round 0 under links:0.3")
        assert [r[0] for r in rows] == [name for name, _ in mod.REGIMES]
        assert [r[1] for r in rows] == [spec for _, spec in mod.REGIMES]
        assert all(np.isfinite(float(r[2])) for r in rows)
