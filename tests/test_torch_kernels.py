"""The port's kernel layer on the CPU — the plain versions the wrappers run
for CPU tensors — against ``repro.kernels.ref`` (and once against the
Pallas kernels in interpret mode, as the reference's own tests run them).

Tolerances: f32 atol 1e-5 (the reference's parity contract,
docs/kernels.md); bf16 compared in f32 within atol = rtol = 3e-2 (about two
bf16 ulps at |psi| < 4, the reference's own bf16 tolerance); squared norms
rtol 1e-5 (sums over D taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import graph_combine as t_gc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import round_fold as t_rf

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(P, L, D, dtype, per_client, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((P, L, D) if per_client else (P, D))
    g = 3 * rng.standard_normal((P, L, D))
    noise = 0.3 * rng.standard_normal((P, L, D))
    pre = rng.uniform(0.3, 2.0, (P, L))
    fold = rng.uniform(0.0, 1.0, (P, L))
    fold[:, 0] = 0.0                      # a client with zero fold weight
    nw = rng.uniform(0.1, 1.0, (P, L))
    nw[:, L // 2] = 0.0                   # a dead client: its pairs vanish
    nw = nw / nw.sum(axis=1, keepdims=True)
    seeds = (np.arange(P) * 2654435761 + 7) % 2 ** 32
    # round through the working dtype once, so both sides see equal inputs
    as_dt = lambda x: np.asarray(jnp.asarray(x, JDT[dtype]).astype(  # noqa
        jnp.float32))
    return dict(w=as_dt(w), g=as_dt(g), noise=as_dt(noise),
                pre=pre.astype(np.float32), fold=fold.astype(np.float32),
                nw=nw.astype(np.float32), seeds=seeds.astype(np.uint32))


def _ref_round_fold(x, dtype, mode, **kw):
    return ref_ref.round_fold_ref(
        jnp.asarray(x["w"], JDT[dtype]), jnp.asarray(x["g"], JDT[dtype]),
        pre_w=jnp.asarray(x["pre"]), fold_w=jnp.asarray(x["fold"]),
        noise_w=jnp.asarray(x["nw"]), mode=mode,
        seeds=jnp.asarray(x["seeds"]),
        noise=jnp.asarray(x["noise"], JDT[dtype]), **kw)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0 if dtype == "float32" else tol)


@pytest.mark.parametrize("impl", ["ops", "ref"])
@pytest.mark.parametrize("mode", ["none", "laplace", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_client", [False, True])
@pytest.mark.parametrize("P,L,D", [(3, 5, 130), (2, 13, 509)])
def test_round_fold_plain_vs_reference(impl, mode, dtype, per_client, P, L,
                                       D):
    x = _inputs(P, L, D, dtype, per_client)
    kw = dict(mu=0.1, bound=2.0, sigma=0.5)
    psi_r, sq_r = _ref_round_fold(x, dtype, mode, **kw)
    dt = TDT[dtype]
    args = dict(pre_w=_t(x["pre"]), fold_w=_t(x["fold"]),
                noise_w=_t(x["nw"]), mode=mode,
                seeds=torch.as_tensor(x["seeds"].astype(np.int64)),
                noise=_t(x["noise"], dt), **kw)
    fn = t_ops.round_fold if impl == "ops" else t_ref.round_fold_ref
    psi, sq = fn(_t(x["w"], dt), _t(x["g"], dt), **args)
    assert psi.dtype == dt and psi.shape == (P, D)
    _close(psi, psi_r, dtype)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_r), rtol=1e-5)


def test_round_fold_plain_vs_pallas_interpret():
    """One case against the Pallas kernels themselves (interpret mode on
    the CPU, D padded to the tile).  L is a multiple of 8: the Pallas path
    pads L and numbers the mask pairs by the padded L, so with non-uniform
    noise weights and ragged L it departs from the reference's own ref
    backend, which the port follows (ROADMAP, faults found)."""
    P, L, D = 3, 8, 200
    x = _inputs(P, L, D, "float32", False, seed=4)
    kw = dict(mu=0.1, bound=2.0, sigma=0.5, mode="mask")
    psi_p, sq_p = ref_ops.round_fold(
        jnp.asarray(x["w"]), jnp.asarray(x["g"]),
        pre_w=jnp.asarray(x["pre"]), fold_w=jnp.asarray(x["fold"]),
        noise_w=jnp.asarray(x["nw"]), seeds=jnp.asarray(x["seeds"]),
        backend="pallas", interpret=True, **kw)
    psi, sq = t_ops.round_fold(
        _t(x["w"]), _t(x["g"]), pre_w=_t(x["pre"]), fold_w=_t(x["fold"]),
        noise_w=_t(x["nw"]),
        seeds=torch.as_tensor(x["seeds"].astype(np.int64)), **kw)
    _close(psi, psi_p, "float32")
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_p), rtol=1e-5)


@pytest.mark.parametrize("P,L,D", [(4, 6, 509), (2, 13, 64)])
def test_hash_net_mask_fold_vs_reference(P, L, D):
    x = _inputs(P, L, D, "float32", False, seed=2)
    want = jax.vmap(lambda sd, nw: ref_ref.hash_net_mask_fold(
        sd, nw, D, 0.4))(jnp.asarray(x["seeds"]), jnp.asarray(x["nw"]))
    got = t_ref.hash_net_mask_fold(
        torch.as_tensor(x["seeds"].astype(np.int64)), _t(x["nw"]), D, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_uniform_mask_weights_cancel():
    """eq. 23: with uniform weights every pair's stream cancels."""
    got = t_ref.hash_net_mask_fold(torch.tensor([5, 9]),
                                   torch.full((2, 7), 1 / 7), 300, 1.0)
    assert float(got.abs().max()) < 1e-6


@pytest.mark.parametrize("variant", ["g", "none", "gate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,D", [(10, 509), (3, 2)])
def test_graph_combine_plain_vs_reference(variant, dtype, P, D):
    rng = np.random.default_rng(P + D)
    A = rng.uniform(0.0, 1.0, (P, P))
    A = (A / A.sum(axis=0, keepdims=True)).astype(np.float32)
    as_dt = lambda v: np.asarray(jnp.asarray(v, JDT[dtype]).astype(  # noqa
        jnp.float32))
    psi = as_dt(rng.standard_normal((P, D)))
    g = as_dt(0.2 * rng.standard_normal((P, D)))
    cache = as_dt(rng.standard_normal((P, D)))
    gate = (np.arange(P) % 3 != 0)
    jdt, tdt = JDT[dtype], TDT[dtype]
    kw_r, kw_t = {}, {}
    if variant == "gate":
        kw_r = dict(cache=jnp.asarray(cache, jdt), gate=jnp.asarray(gate))
        kw_t = dict(cache=_t(cache, tdt), gate=torch.as_tensor(gate))
    g_r = None if variant == "none" else jnp.asarray(g, jdt)
    g_t = None if variant == "none" else _t(g, tdt)
    want = ref_ops.graph_combine(jnp.asarray(A), jnp.asarray(psi, jdt), g_r,
                                 backend="ref", **kw_r)
    got = t_ops.graph_combine(torch.as_tensor(A), _t(psi, tdt), g_t, **kw_t)
    assert got.dtype == tdt
    _close(got, want, dtype)


def test_graph_combine_ref_vs_reference():
    rng = np.random.default_rng(3)
    a_t = rng.uniform(size=(5, 5)).astype(np.float32)
    psi = rng.standard_normal((5, 77)).astype(np.float32)
    g = rng.standard_normal((5, 77)).astype(np.float32)
    want = ref_ref.graph_combine_ref(jnp.asarray(a_t), jnp.asarray(psi),
                                     jnp.asarray(g))
    got = t_ref.graph_combine_ref(_t(a_t), _t(psi), _t(g))
    _close(got, want, "float32")


def test_apply_gate_matches_reference():
    psi, cache = np.ones((4, 3), np.float32), np.zeros((4, 3), np.float32)
    gate = np.array([1, 0, 1, 0], bool)
    want = ref_ops.apply_gate(jnp.asarray(psi), jnp.asarray(gate),
                              jnp.asarray(cache))
    got = t_ops.apply_gate(_t(psi), torch.as_tensor(gate), _t(cache))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert t_ops.apply_gate(_t(psi), None, None) is not None


def test_wrappers_reject_bad_operands():
    g = torch.zeros((2, 3, 8))
    with pytest.raises(TypeError, match="dtype"):
        t_rf.fold_norms(g.double())
    with pytest.raises(ValueError, match="contiguous"):
        t_rf.fold_norms(torch.zeros((2, 8, 3)).transpose(1, 2))
    ss = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="shape"):
        t_rf.fold_apply(torch.zeros((2, 7)), g, ss, ss, ss)
    with pytest.raises(ValueError, match="seeds"):
        t_rf.fold_apply(torch.zeros((2, 8)), g, ss, ss, ss, mode="mask")
    with pytest.raises(ValueError, match="unknown fold mode"):
        t_rf.fold_apply(torch.zeros((2, 8)), g, ss, ss, ss, mode="gauss")
    with pytest.raises(ValueError, match="gate and cache"):
        t_gc.graph_combine(torch.eye(2), torch.zeros((2, 4)),
                           gate=torch.ones(2))


def test_plain_versions_launch_nothing_on_cpu():
    from repro_torch import kernels as K
    K.reset_launches()
    x = _inputs(2, 3, 10, "float32", False)
    t_ops.round_fold(_t(x["w"]), _t(x["g"]), mu=0.1, bound=1.0)
    t_ops.graph_combine(torch.eye(2), _t(x["w"]))
    assert all(n == 0 for n in K.LAUNCHES.values())
