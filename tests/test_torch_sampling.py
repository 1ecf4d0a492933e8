"""The port's importance sampler (``repro_torch.core.sampling``) against
``repro.core.sampling``, on the CPU.

Tolerances: ``sampling_probs`` and ``importance_weights`` within atol 1e-6
of the reference (f32; the row sums may add in another order); the
estimate update within atol 1e-6, its counts exactly; the weighted draw's
indices equal to ``jax.random.choice``'s on the same uniforms but for the
draws whose uniform lands within 2^-22 of a CDF step (the reference sums
its CDF in f32, the port in f64; such ties are counted and must be rare);
row sums of the probabilities within 1e-5 of 1, as the reference's tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro.core import sampling as REF
from repro_torch.core import sampling as IS

ATOL = 1e-6


def _ref_state(est):
    est = jnp.asarray(est, jnp.float32)
    return REF.ISState(est, jnp.zeros(est.shape, jnp.int32))


def _state(est):
    est = torch.tensor(np.asarray(est, np.float32))
    return IS.ISState(est, torch.zeros(est.shape, dtype=torch.int32))


def _degenerate(rng, P, K, kind):
    est = rng.gamma(1.0, 5.0, size=(P, K)).astype(np.float32)
    if kind == "zeros":
        est[rng.integers(0, P)] = 0.0
    elif kind == "inf":
        est[rng.integers(0, P), rng.integers(0, K)] = np.inf
    elif kind == "nan":
        est[rng.integers(0, P), rng.integers(0, K)] = np.nan
    elif kind == "ninf":
        est[rng.integers(0, P), rng.integers(0, K)] = -np.inf
    elif kind == "mixed":
        est[:] = rng.choice([0.0, 1.0, np.inf, np.nan, 1e30, -1.0],
                            size=(P, K))
    return est


@given(P=st.integers(1, 4), K=st.integers(2, 24),
       seed=st.integers(0, 2 ** 31 - 1),
       kind=st.sampled_from(["none", "zeros", "inf", "nan", "ninf",
                             "mixed"]),
       floor=st.floats(0.0, 0.5))
@settings(max_examples=60, deadline=None)
def test_sampling_probs_equal_reference(P, K, seed, kind, floor):
    """Rows are distributions for arbitrary estimates, NaN / inf / zero
    rows included, and equal the reference's."""
    est = _degenerate(np.random.default_rng(seed), P, K, kind)
    got = IS.sampling_probs(_state(est), floor=floor).numpy()
    want = np.asarray(REF.sampling_probs(_ref_state(est), floor=floor))
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sampling_probs_degenerate_examples():
    p = IS.sampling_probs(_state(np.zeros((2, 5)))).numpy()
    np.testing.assert_allclose(p, 0.2, atol=1e-6)       # all-zero: uniform
    est = np.ones((1, 4))
    est[0, 0] = np.inf
    p = IS.sampling_probs(_state(est)).numpy()
    assert (p[0, 1:] > 0).all()                         # inf capped
    est = np.ones((1, 4))
    est[0, 2] = np.nan
    np.testing.assert_allclose(IS.sampling_probs(_state(est)).numpy(), 0.25,
                               atol=1e-6)               # NaN: unit prior
    p = IS.sampling_probs(_state([[1.0, 3.0]])).numpy()
    assert p[0, 1] == pytest.approx(0.75, rel=1e-6)


@pytest.mark.parametrize("k_norm", [None, "scalar", "rows"])
def test_importance_weights_equal_reference(k_norm):
    rng = np.random.default_rng(4)
    P, K, L = 3, 16, 7
    est = rng.gamma(1.0, 2.0, size=(P, K)).astype(np.float32)
    probs = np.asarray(REF.sampling_probs(_ref_state(est)))
    idx = rng.integers(0, K, size=(P, L))
    kn = {None: None, "scalar": 11.0,
          "rows": np.asarray([5.0, 9.0, 16.0], np.float32)}[k_norm]
    want = np.asarray(REF.importance_weights(
        jnp.asarray(probs), jnp.asarray(idx),
        k_norm=None if kn is None else jnp.asarray(kn)))
    got = IS.importance_weights(
        torch.tensor(probs), torch.tensor(idx),
        k_norm=None if kn is None else (torch.tensor(kn) if k_norm == "rows"
                                        else kn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@given(seed=st.integers(0, 2 ** 31 - 1), K=st.integers(2, 20),
       floor=st.floats(0.01, 0.5))
@settings(max_examples=25, deadline=None)
def test_unbiasedness_property(seed, K, floor):
    """sum_k pi_k x_k w_k = mean(x) for any estimates and floor."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, K))
    est = rng.gamma(0.7, 3.0, size=(1, K)).astype(np.float32)
    probs = IS.sampling_probs(_state(est), floor=floor)
    w = IS.importance_weights(probs, torch.arange(K)[None])
    expectation = float((probs.double() * torch.tensor(x) * w.double()).sum())
    assert expectation == pytest.approx(float(x.mean()), rel=1e-4, abs=1e-6)


def test_importance_weights_k_norm_targets_available_mean():
    rng = np.random.default_rng(2)
    K = 10
    x = rng.normal(size=(1, K))
    avail = torch.ones((1, K), dtype=torch.bool)
    avail[0, 7:] = False
    eff = torch.full((1, K), 1.0 / K) * avail
    eff = eff / eff.sum(dim=1, keepdim=True)
    w = IS.importance_weights(eff, torch.arange(K)[None],
                              k_norm=torch.tensor([7.0]))
    expectation = float((eff.double() * torch.tensor(x) * w.double()).sum())
    assert expectation == pytest.approx(float(x[0, :7].mean()), rel=1e-4)


# --------------------------------------------------- the estimate update --


def test_update_with_duplicates_keeps_the_last_slot():
    """A client drawn twice in a row: the reference keeps the last slot's
    EMA (0.7 * 1 + 0.3 * 40 = 12.7); counts add every slot."""
    idx = np.asarray([[2, 2, 3, 2]])
    norms = np.asarray([[10.0, 20.0, 30.0, 40.0]], np.float32)
    ref = REF.update_norm_estimates(REF.init_is_state(1, 5),
                                    jnp.asarray(idx), jnp.asarray(norms))
    got = IS.update_norm_estimates(IS.init_is_state(1, 5),
                                   torch.tensor(idx), torch.tensor(norms))
    assert float(ref.norm_est[0, 2]) == pytest.approx(12.7, rel=1e-6)
    np.testing.assert_allclose(got.norm_est.numpy(),
                               np.asarray(ref.norm_est), atol=ATOL)
    assert got.counts.tolist() == [[0, 0, 3, 1, 0]]
    assert np.array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert got.counts.dtype == torch.int32


@given(seed=st.integers(0, 2 ** 31 - 1), P=st.integers(1, 4),
       K=st.integers(1, 9), L=st.integers(1, 12),
       decay=st.floats(0.0, 1.0))
@settings(max_examples=60, deadline=None)
def test_update_equals_reference_with_repeats(seed, P, K, L, decay):
    """Indices drawn with replacement from few clients, so rows repeat."""
    rng = np.random.default_rng(seed)
    est = rng.gamma(1.0, 2.0, size=(P, K)).astype(np.float32)
    cnt = rng.integers(0, 5, size=(P, K)).astype(np.int32)
    idx = rng.integers(0, K, size=(P, L))
    norms = rng.gamma(1.0, 3.0, size=(P, L)).astype(np.float32)
    ref = REF.update_norm_estimates(
        REF.ISState(jnp.asarray(est), jnp.asarray(cnt)), jnp.asarray(idx),
        jnp.asarray(norms), decay=decay)
    got = IS.update_norm_estimates(
        IS.ISState(torch.tensor(est), torch.tensor(cnt)), torch.tensor(idx),
        torch.tensor(norms), decay=decay)
    np.testing.assert_allclose(got.norm_est.numpy(),
                               np.asarray(ref.norm_est), atol=ATOL)
    assert np.array_equal(got.counts.numpy(), np.asarray(ref.counts))


def test_update_only_touches_sampled():
    state = IS.init_is_state(2, 6)
    new = IS.update_norm_estimates(state, torch.tensor([[0, 2], [5, 5]]),
                                   torch.tensor([[4.0, 8.0], [2.0, 2.0]]))
    est = new.norm_est.numpy()
    assert est[0, 0] != 1.0 and est[0, 2] != 1.0 and est[1, 5] != 1.0
    np.testing.assert_array_equal(est[0, [1, 3, 4, 5]], 1.0)
    np.testing.assert_array_equal(est[1, :5], 1.0)


# ------------------------------------------------------ the weighted draw --


def _cdf_ties(probs, u, tol=2.0 ** -22):
    """Draws whose r = cdf[-1] (1 - u) lies within ``tol`` of a CDF step."""
    cdf = np.cumsum(probs.astype(np.float64), axis=1)
    r = cdf[:, -1:] * (1.0 - u.astype(np.float64))
    return (np.abs(r[:, :, None] - cdf[:, None, :]) <= tol).any(axis=2)


@pytest.mark.parametrize("K,L,avail_frac", [(16, 8, 1.0), (1000, 50, 0.3),
                                            (100_000, 20, 0.5)])
def test_sample_clients_is_jax_choice(K, L, avail_frac):
    """The same uniforms and probabilities give the reference's indices,
    but for counted ties at a CDF step, and never an unavailable client."""
    P = 3
    rng = np.random.default_rng(K)
    est = rng.gamma(1.0, 2.0, size=(P, K)).astype(np.float32)
    avail = rng.random((P, K)) < avail_frac
    avail[:, 0] = True
    probs = np.asarray(REF.sampling_probs(_ref_state(est))) * avail
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(K), P)
    want = np.stack([np.asarray(jax.random.choice(
        keys[p], K, (L,), replace=True, p=jnp.asarray(probs[p])))
        for p in range(P)])
    u = np.stack([np.asarray(jax.random.uniform(keys[p], (L,),
                                                dtype=jnp.float32))
                  for p in range(P)])
    got = IS.sample_clients(torch.tensor(probs), torch.tensor(u)).numpy()
    assert got.shape == (P, L) and got.dtype == np.int64
    assert avail[np.arange(P)[:, None], got].all()
    differ = got != want
    assert not (differ & ~_cdf_ties(probs, u)).any()
    assert differ.sum() <= max(1, P * L // 100)


@given(seed=st.integers(0, 2 ** 31 - 1), K=st.integers(1, 40),
       L=st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_sample_clients_never_picks_probability_zero(seed, K, L):
    rng = np.random.default_rng(seed)
    probs = rng.gamma(1.0, 1.0, size=(2, K)) * (rng.random((2, K)) < 0.4)
    probs[:, rng.integers(0, K)] = 1.0
    probs = torch.tensor(probs / probs.sum(axis=1, keepdims=True),
                         dtype=torch.float32)
    u = torch.tensor(rng.random((2, L)), dtype=torch.float32)
    u[0, 0] = 0.0                      # r = cdf[-1], the last step
    u[1, 0] = 1.0 - 2.0 ** -24         # the smallest r
    idx = IS.sample_clients(probs, u)
    assert ((0 <= idx) & (idx < K)).all()
    assert (torch.gather(probs, 1, idx) > 0).all()


def test_sample_clients_realizes_the_probabilities():
    """Frequencies over many uniforms follow pi to their sampling error."""
    probs = torch.tensor([[0.5, 0.0, 0.3, 0.2]])
    u = torch.rand((1, 200_000), generator=torch.Generator().manual_seed(0))
    freq = torch.bincount(IS.sample_clients(probs, u)[0], minlength=4)
    np.testing.assert_allclose(freq.numpy() / 200_000, probs[0].numpy(),
                               atol=4e-3)
