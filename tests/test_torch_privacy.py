"""The port's privacy layer against ``repro.core.privacy`` with the
reference's own draws injected: the samplers' transforms, the pairwise
masks and the combines.  Tolerance: f32 atol 1e-6 (elementwise transforms,
one log1p apart) and 1e-5 for the combines (the parity contract)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.privacy import homomorphic as ref_hom
from repro.core.privacy import noise as ref_noise
from repro.core.privacy import secure_agg as ref_sa
from repro.core.topology import combination_matrix
from repro_torch.core.privacy import homomorphic as t_hom
from repro_torch.core.privacy import noise as t_noise
from repro_torch.core.privacy import secure_agg as t_sa

from test_torch_parity import U_HI, U_LO, _pair_normals


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("sigma", [0.2, 1.5])
def test_laplace_from_injected_uniforms(sigma):
    key = jax.random.PRNGKey(3)
    shape = (4, 5, 33)
    want = ref_noise.sample_laplace(key, shape, sigma)
    u = jax.random.uniform(key, shape, jnp.float32, minval=U_LO, maxval=U_HI)
    got = t_noise.sample_laplace(shape, sigma, uniforms=_t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_laplace_transform_matches_reference_oracle():
    u = np.linspace(U_LO, U_HI, 1001, dtype=np.float32)
    want = ref_noise.laplace_from_uniform(jnp.asarray(u), 0.7)
    got = t_noise.laplace_from_uniform(_t(u), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_gaussian_from_injected_normals():
    key = jax.random.PRNGKey(4)
    want = ref_noise.sample_gaussian(key, (6, 9), 0.3)
    z = jax.random.normal(key, (6, 9), jnp.float32)
    got = t_noise.sample_gaussian((6, 9), 0.3, normals=_t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_generator_samplers_have_the_stated_moments():
    gen = torch.Generator().manual_seed(0)
    lap = t_noise.sample_laplace((200_000,), 0.5, generator=gen)
    gau = t_noise.sample_gaussian((200_000,), 0.5, generator=gen)
    for x in (lap, gau):
        assert abs(float(x.mean())) < 0.01
        assert abs(float(x.std()) - 0.5) < 0.01
    with pytest.raises(ValueError, match="generator or uniforms"):
        t_noise.sample_laplace((3,), 1.0)
    with pytest.raises(ValueError, match="unknown noise distribution"):
        t_noise.get_sampler("cauchy")


@pytest.mark.parametrize("L", [2, 5, 9])
def test_pairwise_masks_with_injected_streams(L):
    key, D = jax.random.PRNGKey(L), 17
    want = ref_sa.pairwise_masks_vec(key, L, D, 0.4)
    normals = _pair_normals(key, L, D)
    got = t_sa.pairwise_masks_vec(L, D, 0.4, normals=_t(normals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    S = t_sa.pair_stream_matrix(L, D, 0.4, normals=_t(normals))
    np.testing.assert_allclose(
        S.numpy(), np.asarray(ref_sa.pair_stream_matrix(key, L, D, 0.4)),
        atol=0)
    assert float(got.sum(dim=0).abs().max()) < 1e-5     # eq. 23


def test_pairwise_masks_batch_over_servers():
    gen = torch.Generator().manual_seed(1)
    normals = torch.randn((3, 10, 8), generator=gen)      # P=3, L=5
    batched = t_sa.pairwise_masks_vec(5, 8, 0.2, normals=normals)
    for p in range(3):
        assert torch.equal(batched[p], t_sa.pairwise_masks_vec(
            5, 8, 0.2, normals=normals[p]))


@pytest.mark.parametrize("topology", ["ring", "full"])
@pytest.mark.parametrize("distribution", ["laplace", "gaussian"])
def test_homomorphic_combine_with_injected_noise(topology, distribution):
    P, D = 6, 23
    A = combination_matrix(topology, P)
    key = jax.random.PRNGKey(9)
    psi = np.random.default_rng(0).standard_normal((P, D)).astype(np.float32)
    want = ref_hom.homomorphic_combine_noise(key, jnp.asarray(A),
                                             jnp.asarray(psi), 0.3,
                                             distribution=distribution)
    g = ref_noise.get_sampler(distribution)(key, (P, D), 0.3, jnp.float32)
    got = t_hom.homomorphic_combine_noise(_t(A), _t(psi), _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # eq. 25: the network centroid sees none of the noise
    clean = t_hom.combine_nonprivate(_t(A), _t(psi))
    np.testing.assert_allclose(got.mean(0).numpy(), clean.mean(0).numpy(),
                               atol=1e-5)


def test_iid_combine_with_injected_noise():
    P, D = 5, 11
    A = combination_matrix("ring", P)
    key = jax.random.PRNGKey(2)
    psi = np.random.default_rng(1).standard_normal((P, D)).astype(np.float32)
    want = ref_hom.iid_noise_combine(key, jnp.asarray(A), jnp.asarray(psi),
                                     0.3)
    g = ref_noise.sample_laplace(key, (P, P, D), 0.3)
    got = t_hom.iid_noise_combine(_t(A), _t(psi), _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_combine_nonprivate_matches_reference():
    A = combination_matrix("ring", 4)
    psi = np.arange(12, dtype=np.float32).reshape(4, 3)
    want = ref_hom.combine_nonprivate(jnp.asarray(A), jnp.asarray(psi))
    got = t_hom.combine_nonprivate(_t(A), _t(psi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
