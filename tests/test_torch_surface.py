"""The public surface the ported modules gained, each beside its reference
counterpart on the same numbers (the reference's draws replayed):
``core.privacy``'s 28 names, the loop secure-aggregation oracles,
``homomorphic_noise_matrix``, ``gfl.server_aggregate`` /
``server_combine``, ``simulate.sample_round_batches``,
``configs.registry.all_configs``, ``telemetry``'s 29 names and
``core.fleet``.  Tolerances: f32 atol 1e-6 for the masks and 1e-5 for
sums over clients (the reference's parity contract), indices exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.privacy as ref_privacy
import repro.telemetry as ref_telemetry
from repro.configs import registry as ref_registry
from repro.configs.base import GFLConfig as RefConfig
from repro.core import gfl as ref_gfl
from repro.core import simulate as ref_simulate
from repro.core.population.engine import uniform_cohort_indices
from repro.core.privacy import homomorphic as ref_hom
from repro.core.privacy import noise as ref_noise
from repro.core.privacy import secure_agg as ref_sa
from repro.core.topology import combination_matrix
import repro_torch.core.privacy as port_privacy
import repro_torch.telemetry as port_telemetry
from repro_torch.configs import registry
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import problem_from_numpy
from repro_torch.core import gfl
from repro_torch.core import simulate
from repro_torch.core.privacy import homomorphic as hom
from repro_torch.core.privacy import secure_agg as sa
from repro_torch.draws import ReplayDraws

from test_torch_parity import _pair_normals, _uniforms


def _t(x):
    return torch.from_numpy(np.array(x))


def test_privacy_exports_are_the_references():
    assert port_privacy.__all__ == ref_privacy.__all__
    assert len(port_privacy.__all__) == 28
    for name in port_privacy.__all__:
        assert callable(getattr(port_privacy, name)), name


def test_telemetry_exports_are_the_references():
    assert sorted(port_telemetry.__all__) == sorted(ref_telemetry.__all__)
    assert len(port_telemetry.__all__) == 29


def test_fleet_exports_the_spec_grammar():
    import repro.core.fleet as ref_fleet
    import repro_torch.core.fleet as fleet
    # the whole fleet is ported now: the spec grammar among the
    # reference's 29 names, in the reference's order
    assert {"FleetSpec", "parse_fleet_spec", "TRANSPORTS"} <= \
        set(fleet.__all__)
    assert fleet.__all__ == ref_fleet.__all__
    assert fleet.parse_fleet_spec("fleet:retry=5").to_spec() == \
        "fleet:retry=5"


@pytest.mark.parametrize("L", [2, 4, 7])
def test_pairwise_masks_loop_equals_the_reference(L):
    key, D = jax.random.PRNGKey(10 + L), 9
    normals = _t(_pair_normals(key, L, D))
    want = ref_sa.pairwise_masks(key, L, D, 0.7)
    got = sa.pairwise_masks(L, D, 0.7, normals=normals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    vec = sa.pairwise_masks_vec(L, D, 0.7, normals=normals)
    np.testing.assert_allclose(got.numpy(), vec.numpy(), atol=1e-6, rtol=0)
    assert float(got.sum(dim=0).abs().max()) < 1e-5          # eq. 23


@pytest.mark.parametrize("L", [3, 6])
def test_masked_client_mean_equals_the_reference(L):
    key, D = jax.random.PRNGKey(L), 5
    upd = np.random.default_rng(L).standard_normal((L, D)).astype(
        np.float32)
    want = ref_sa.masked_client_mean(jnp.asarray(upd), key, 2.0)
    got = sa.masked_client_mean(_t(upd), 2.0,
                                normals=_t(_pair_normals(key, L, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    gen = torch.Generator().manual_seed(3)
    drawn = sa.masked_client_mean(_t(upd), 2.0, generator=gen)
    np.testing.assert_allclose(drawn.numpy(), upd.mean(0), atol=1e-5)


@pytest.mark.parametrize("alive", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0],
                                   [0, 0, 0, 1, 0], [0, 0, 0, 0, 0]])
def test_masked_client_mean_with_dropout_equals_the_reference(alive):
    L, D = 5, 6
    key = jax.random.PRNGKey(4)
    upd = np.random.default_rng(7).standard_normal((L, D)).astype(np.float32)
    a = np.asarray(alive, bool)
    want = ref_sa.masked_client_mean_with_dropout(
        jnp.asarray(upd), key, jnp.asarray(a), 1.5)
    normals = _t(_pair_normals(key, L, D))
    got = sa.masked_client_mean_with_dropout(_t(upd), torch.tensor(a), 1.5,
                                             normals=normals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    vec = sa.masked_client_mean_dropout_vec(_t(upd), torch.tensor(a), 1.5,
                                            normals=normals)
    np.testing.assert_allclose(got.numpy(), vec.numpy(), atol=1e-5, rtol=0)
    if a.any():        # the survivor mean, the masks recovered exactly
        np.testing.assert_allclose(got.numpy(), upd[a].mean(0), atol=1e-5)


@pytest.mark.parametrize("topology", ["ring", "full"])
@pytest.mark.parametrize("distribution", ["laplace", "gaussian"])
def test_homomorphic_noise_matrix_equals_the_reference(topology,
                                                       distribution):
    P, D = 5, 4
    A = combination_matrix(topology, P)
    key = jax.random.PRNGKey(8)
    want = ref_hom.homomorphic_noise_matrix(key, jnp.asarray(A), D, 0.3,
                                            distribution=distribution)
    g = ref_noise.get_sampler(distribution)(key, (P, D), 0.3, jnp.float32)
    got = hom.homomorphic_noise_matrix(_t(A).float(), D, 0.3, g=_t(g),
                                       distribution=distribution)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # eq. 25: (1/P) sum_p sum_m a_mp g_mp = 0
    null = torch.einsum("mp,mpd->d", _t(A).float(), got) / P
    assert float(null.abs().max()) < 1e-5
    drawn = hom.homomorphic_noise_matrix(
        _t(A).float(), D, 0.3, generator=torch.Generator().manual_seed(0),
        distribution=distribution)
    assert drawn.shape == (P, P, D)


SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp"]


def _server_keys(key, P):
    return jax.random.split(key, P)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_server_aggregate_equals_the_reference(scheme):
    P, L, D = 3, 4, 5
    kw = dict(num_servers=P, clients_per_server=L, privacy=scheme,
              sigma_g=0.4)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    w = np.random.default_rng(2).standard_normal((P, L, D)).astype(
        np.float32)
    keys = _server_keys(jax.random.PRNGKey(5), P)
    want = np.stack([np.asarray(ref_gfl.server_aggregate(
        jnp.asarray(w[p]), keys[p], rcfg)) for p in range(P)])
    entries = []
    if scheme == "iid_dp":
        entries = [("client", "laplace_uniform", np.stack(
            [np.asarray(_uniforms(k, (L, D))) for k in keys]))]
    elif scheme in ("hybrid", "gaussian_dp"):
        entries = [("client", "normal", np.stack(
            [np.asarray(_pair_normals(k, L, D)) for k in keys]))]
    draws = ReplayDraws([entries], device="cpu")
    got = gfl.server_aggregate(_t(w), draws, tcfg)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_server_combine_equals_the_reference(scheme):
    P, D = 4, 6
    kw = dict(num_servers=P, privacy=scheme, sigma_g=0.4)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    A = combination_matrix("ring", P)
    psi = np.random.default_rng(3).standard_normal((P, D)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = ref_gfl.server_combine(jnp.asarray(psi), key, jnp.asarray(A),
                                  rcfg)
    entries = []
    if scheme == "iid_dp":
        entries = [("combine", "laplace_uniform",
                    np.asarray(_uniforms(key, (P, P, D))))]
    elif scheme == "hybrid":
        entries = [("combine", "laplace_uniform",
                    np.asarray(_uniforms(key, (P, D))))]
    elif scheme == "gaussian_dp":
        entries = [("combine", "normal", np.asarray(
            jax.random.normal(key, (P, D), jnp.float32)))]
    draws = ReplayDraws([entries], device="cpu")
    got = gfl.server_combine(_t(psi), draws, _t(A).float(), tcfg)
    assert draws.remaining == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_sample_round_batches_equals_the_reference():
    P, K, N, L, B = 3, 7, 9, 4, 3
    ref_prob = ref_simulate.generate_problem(jax.random.PRNGKey(1), P=P,
                                             K=K, N=N, M=2)
    prob = problem_from_numpy(ref_prob.features, ref_prob.labels,
                              ref_prob.rho, ref_prob.w_opt, device="cpu")
    key = jax.random.PRNGKey(9)
    h_want, g_want = ref_simulate.sample_round_batches(key, ref_prob, L, B)
    ci, bi = uniform_cohort_indices(key, P, K, N, L, B)
    draws = ReplayDraws([[("cohort", "cohort",
                           (np.asarray(ci), np.asarray(bi)))]],
                        device="cpu")
    h, g = simulate.sample_round_batches(draws, 0, prob, L, B)
    assert np.array_equal(h.numpy(), np.asarray(h_want))
    assert np.array_equal(g.numpy(), np.asarray(g_want))


def test_all_configs_lists_every_arch_id():
    got = registry.all_configs()
    assert list(got) == [a for a in ref_registry.ARCH_IDS
                         if a != "gfl-logreg"]
    for arch, cfg in got.items():
        assert cfg == registry.get_config(arch)
        assert cfg.name == ref_registry.get_config(arch).name
