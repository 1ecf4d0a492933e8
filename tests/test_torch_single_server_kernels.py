"""The port's single-server kernels on the CPU — the plain versions of K5
``secure_agg_mean``, K6 ``clip_accum`` and K7 ``laplace_transform`` that
the wrappers run for CPU tensors — against ``repro.kernels.ops``, run as
the reference's own tests run it: the Pallas kernels in interpret mode
(``backend="pallas"``) and the jnp oracles (``backend="ref"``).  Inputs
come from numpy.

Tolerances are the reference's (tests/test_kernels.py, test_round_fold.py):
K5 atol 1e-5 against the reference and 1e-4 against the plain mean (2e-4
at L = 64); K7 atol 1e-6; K6 atol = rtol = 1e-5.  bf16 is compared in f32
within atol = rtol = 2e-2, the reference's bf16 limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch import kernels as K
from repro_torch.kernels import clip_accum as t_ca
from repro_torch.kernels import laplace as t_lp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import secure_agg as t_sa

TOL_BF16 = 2e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED = 17


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    # the reference's block autotuner times every candidate in interpret
    # mode; its choice does not change the values, so take the largest
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "0")


def _pair(x, dtype="float32"):
    """The same values as a jax array and a torch tensor in ``dtype``."""
    j = jnp.asarray(np.asarray(x, np.float32)).astype(JDT[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------- K5


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("L", [2, 5, 8])
@pytest.mark.parametrize("D", [128, 1000])
def test_secure_agg_mean_plain_vs_reference(backend, L, D):
    upd = np.random.default_rng(L * D).standard_normal((L, D))
    j, t = _pair(upd)
    seed = np.array([SEED], np.uint32)
    want = ref_ops.secure_agg_mean(j, jnp.asarray(seed), scale=0.7,
                                   backend=backend)
    got = t_ops.secure_agg_mean(t, torch.tensor(seed.astype(np.int64)), 0.7)
    _close(got, want, 1e-5)
    # the masks cancel: the plain mean
    _close(got, upd.astype(np.float32).mean(0), 1e-4)


def test_secure_agg_mean_many_clients_cancel():
    upd = np.random.default_rng(0).standard_normal((64, 256))
    _, t = _pair(upd)
    got = t_ref.secure_agg_mean_plain(t, torch.tensor([SEED]), 0.7)
    _close(got, upd.astype(np.float32).mean(0), 2e-4)


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 0xFFFFFFFF])
def test_secure_agg_mean_seed_dtypes_agree(seed):
    # a uint32 seed held as int64, or as the int32 bit pattern the kernel
    # reads, gives the same streams as the reference's uint32
    upd = np.random.default_rng(1).standard_normal((5, 300))
    j, t = _pair(upd)
    bits = seed - 2 ** 32 if seed >= 2 ** 31 else seed
    a = t_sa.secure_agg_mean(t, torch.tensor([seed], dtype=torch.int64), 2.0)
    b = t_sa.secure_agg_mean(t, torch.tensor([bits], dtype=torch.int32), 2.0)
    assert torch.equal(a, b)
    want = ref_ops.secure_agg_mean(j, jnp.asarray([seed], jnp.uint32),
                                   scale=2.0, backend="ref")
    _close(a, want, 1e-5)


# ------------------------------------------------------------- K7


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("shape", [(4, 128), (10, 1000), (1, 4096)])
@pytest.mark.parametrize("sigma", [0.1, 1.0])
def test_laplace_transform_plain_vs_reference(backend, shape, sigma):
    u = np.random.default_rng(3).uniform(-0.4999, 0.4999, shape)
    j, t = _pair(u)
    want = ref_ops.laplace_transform(j, sigma, backend=backend)
    got = t_ops.laplace_transform(t, sigma)
    _close(got, want, 1e-6)


def test_laplace_transform_sign_of_zero():
    got = t_lp.laplace_transform(torch.zeros((2, 3)), 1.0)
    assert torch.equal(got, torch.zeros((2, 3)))


# ------------------------------------------------------------- K6


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("L", [2, 6])
@pytest.mark.parametrize("D", [128, 509, 2048])
@pytest.mark.parametrize("bound", [0.5, 100.0])
def test_clip_accum_plain_vs_reference(backend, L, D, bound):
    g = 3 * np.random.default_rng(L + D).standard_normal((L, D))
    j, t = _pair(g)
    want = ref_ops.clip_accum(j, bound, backend=backend)
    got = t_ops.clip_accum(t, bound)
    _close(got, want, 1e-5, 1e-5)


def test_clip_accum_enforces_bound():
    g = torch.ones((1, 1024)) * 10.0          # norm = 320
    out = t_ca.clip_accum(g, 1.0)
    assert float(torch.linalg.vector_norm(out)) <= 1.0 + 1e-4


# ------------------------------------------------------------- bf16, reruns


@pytest.mark.parametrize("kernel", ["secure_agg_mean", "laplace_transform",
                                    "clip_accum"])
def test_bf16_plain_vs_reference(kernel):
    rng = np.random.default_rng(5)
    if kernel == "secure_agg_mean":
        j, t = _pair(rng.standard_normal((5, 1000)), "bfloat16")
        want = ref_ops.secure_agg_mean(j, jnp.asarray([SEED], jnp.uint32),
                                       scale=0.7, backend="ref")
        got = t_ops.secure_agg_mean(t, torch.tensor([SEED]), 0.7)
    elif kernel == "laplace_transform":
        j, t = _pair(rng.uniform(-0.499, 0.499, (10, 1000)), "bfloat16")
        want = ref_ops.laplace_transform(j, 1.0, backend="ref")
        got = t_ops.laplace_transform(t, 1.0)
    else:
        j, t = _pair(3 * rng.standard_normal((6, 509)), "bfloat16")
        want = ref_ops.clip_accum(j, 0.5, backend="ref")
        got = t_ops.clip_accum(t, 0.5)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), TOL_BF16, TOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reruns_bitwise_equal(dtype):
    rng = np.random.default_rng(9)
    _, upd = _pair(rng.standard_normal((6, 300)), dtype)
    _, u = _pair(rng.uniform(-0.49, 0.49, (3, 300)), dtype)
    seed = torch.tensor([SEED])
    for fn in (lambda: t_ops.secure_agg_mean(upd, seed, 0.7),
               lambda: t_ops.laplace_transform(u, 0.5),
               lambda: t_ops.clip_accum(upd, 0.5)):
        assert torch.equal(fn(), fn())


def test_plain_versions_launch_nothing_on_cpu():
    K.reset_launches()
    upd = torch.randn(4, 64)
    t_ops.secure_agg_mean(upd, 3)
    t_ops.laplace_transform(torch.rand(2, 64) - 0.5, 1.0)
    t_ops.clip_accum(upd, 1.0)
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        t_sa.secure_agg_mean(torch.randn(3, 4, 5), torch.tensor([1]))
    with pytest.raises(ValueError):
        t_sa.secure_agg_mean(torch.randn(3, 4), torch.tensor([1, 2]))
    with pytest.raises(TypeError):
        t_sa.secure_agg_mean(torch.randn(3, 4), torch.tensor([1.0]))
    with pytest.raises(TypeError):
        t_lp.laplace_transform(torch.rand(2, 4, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        t_ca.clip_accum(torch.randn(4, 6).T, 1.0)       # not contiguous
