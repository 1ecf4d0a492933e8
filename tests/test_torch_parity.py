"""Parity helpers for the PyTorch port's tests, and tests of the helpers.

Replays the reference's key schedule with the JAX package's own functions
and returns its draws as numpy arrays, in the order the port asks for
them, ready for :class:`repro_torch.draws.ReplayDraws`.  The schedule is
``_run_pure_loop`` (cohort key ``kb`` per round, engine.py), the jitted
``make_gfl_step`` (``split(state.key)``, gfl.py) and ``gfl_round``
(``key_round, key_combine``, then one key per server): the mask seeds of
``_fused_client_fold``, the Laplace client noise, the Gaussian pair
streams of ``pairwise_masks_vec`` and the combine noise of the mechanisms.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.population.engine import uniform_cohort_indices
from repro.core.privacy.mechanism import RoundContext, mechanism_for

U_LO, U_HI = -0.5 + 1e-7, 0.5 - 1e-7


def _uniforms(key, shape):
    return jax.random.uniform(key, shape, jnp.float32, minval=U_LO,
                              maxval=U_HI)


def _pair_normals(key, L, D):
    jj, kk = jnp.triu_indices(L, k=1)

    def draw(j, k):
        return jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, j), k), (D,),
            jnp.float32)

    return jax.vmap(draw)(jj, kk)                            # [npairs, D]


def _distribution(mech):
    inner = getattr(mech, "inner", mech)
    return getattr(inner, "distribution", None), type(inner).__name__


def round_draws(mech, cfg, key_round, key_combine, step, P, L, D, *,
                traced: bool, combine: bool = True):
    """The client- and server-level draws of one round, as replay entries.

    ``traced`` mirrors whether the reference runs the round with a traced
    step (inside its jitted step function): a concrete jax scalar makes
    the reference's static-scale check fail exactly as tracing does."""
    server_keys = jax.random.split(key_round, P)
    ctx = RoundContext(step=jnp.int32(step) if traced else step)
    out = []
    spec = mech.fold_spec(ctx) if cfg.use_kernels else None
    dist, inner_name = _distribution(mech)
    if spec is not None:
        if spec.mode == "mask":
            seeds = jax.vmap(lambda k: jax.random.randint(
                k, (1,), 0, 2 ** 31 - 1)[0])(server_keys)
            out.append(("client", "mask_seeds",
                        np.asarray(seeds.astype(jnp.uint32))))
        elif spec.mode == "laplace":
            out.append(("client", "laplace_uniform", np.asarray(
                jax.vmap(lambda k: _uniforms(k, (L, D)))(server_keys))))
    elif inner_name == "IIDLaplaceDP":
        out.append(("client", "laplace_uniform", np.asarray(
            jax.vmap(lambda k: _uniforms(k, (L, D)))(server_keys))))
    elif dist is not None and cfg.secure_agg:     # hybrid family
        out.append(("client", "normal", np.asarray(
            jax.vmap(lambda k: _pair_normals(k, L, D))(server_keys))))
    if not combine:
        return out
    if inner_name == "IIDLaplaceDP":
        out.append(("combine", "laplace_uniform",
                    np.asarray(_uniforms(key_combine, (P, P, D)))))
    elif dist == "laplace":
        out.append(("combine", "laplace_uniform",
                    np.asarray(_uniforms(key_combine, (P, D)))))
    elif dist == "gaussian":
        out.append(("combine", "normal", np.asarray(
            jax.random.normal(key_combine, (P, D), jnp.float32))))
    return out


def gfl_round_draws(cfg, key, P, L, D, step=0):
    """Draws of one direct ``gfl.gfl_round(params, batch, key, ...)`` call
    (concrete step)."""
    key_round, key_combine = jax.random.split(key)
    return round_draws(mechanism_for(cfg), cfg, key_round, key_combine,
                       step, P, L, D, traced=False)


def run_gfl_draws(cfg, P, K, N, D, *, iters, batch_size, seed):
    """Every draw of ``repro.core.simulate.run_gfl(..., seed=seed)`` on the
    pure path, round by round."""
    mech = mechanism_for(cfg)
    L = cfg.effective_clients
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    _, state_key = jax.random.split(k_init)           # gfl.init_state
    rounds = []
    for i in range(iters):
        key, kb = jax.random.split(key)
        ci, bi = uniform_cohort_indices(kb, P, K, N, L, batch_size)
        entries = [("cohort", "cohort", (np.asarray(ci), np.asarray(bi)))]
        state_key, sub = jax.random.split(state_key)
        key_round, key_combine = jax.random.split(sub)
        tau = cfg.combine_every
        entries += round_draws(mech, cfg, key_round, key_combine, i, P, L, D,
                               traced=True,
                               combine=tau <= 1 or i % tau == tau - 1)
        rounds.append(entries)
    return rounds


# ---------------------------------------------------------- helper tests


def test_replayed_client_noise_is_the_reference_sampler_draw():
    """The uniforms replayed for iid_dp's client level turn into exactly
    the noise the reference's sampler draws on each server key."""
    from repro.configs.base import GFLConfig
    from repro.core.privacy.noise import sample_laplace
    P, L, D = 3, 4, 5
    cfg = GFLConfig(num_servers=P, privacy="iid_dp", sigma_g=0.3)
    key = jax.random.PRNGKey(8)
    entries = gfl_round_draws(cfg, key, P, L, D)
    assert [(s, k) for s, k, _ in entries] == [
        ("client", "laplace_uniform"), ("combine", "laplace_uniform")]
    key_round, _ = jax.random.split(key)
    server_keys = jax.random.split(key_round, P)
    for p in range(P):
        want = np.asarray(sample_laplace(server_keys[p], (L, D), 0.3))
        b = np.float32(0.3) / np.sqrt(np.float32(2.0))
        u = entries[0][2][p]
        got = -b * np.sign(u) * np.log1p(-2.0 * np.abs(u))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_run_gfl_draws_follow_the_kernel_switch():
    """Kernels on: hash-mask seeds; off: Gaussian pair streams; the cohort
    and the combine noise are the same draws either way."""
    from dataclasses import replace

    from repro.configs.base import GFLConfig
    cfg = GFLConfig(num_servers=2, clients_per_server=3, privacy="hybrid")
    on = run_gfl_draws(replace(cfg, use_kernels=True), 2, 3, 6, 2,
                       iters=2, batch_size=2, seed=1)
    off = run_gfl_draws(cfg, 2, 3, 6, 2, iters=2, batch_size=2, seed=1)
    for r_on, r_off in zip(on, off):
        assert [k for _, k, _ in r_on] == ["cohort", "mask_seeds",
                                          "laplace_uniform"]
        assert [k for _, k, _ in r_off] == ["cohort", "normal",
                                           "laplace_uniform"]
        assert np.array_equal(r_on[0][2][0], r_off[0][2][0])
        assert np.array_equal(r_on[-1][2], r_off[-1][2])
