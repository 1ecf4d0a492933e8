"""K8 ``swa_decode`` on the CPU: the port's plain version and its
``ops.swa_decode_attention`` (which run for CPU tensors) against the
reference's Pallas kernel in interpret mode, as the reference's own tests
run it, and against its pure-jnp oracle ``ref.swa_decode_attention_ref``.

Inputs come from a numpy seed and reach both sides as the same f32
numbers.  The reference's wrapper repeats KV heads to H; the port indexes
KV head ``h // G``.  Tolerance: f32 atol 1e-5 (the reference's parity
contract, docs/kernels.md): the sums are the same, taken in another order.
C = 2047 is held against ``ref`` only: the Pallas tile loop falls back to
tiles of one slot there, which interpret mode runs far too slowly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import swa_decode as t_swa

ATOL = 1e-5
B, H = 2, 8


def _inputs(C, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, Dh)).astype(np.float32)
    return q, k, v


def _ref(q, k, v, nv):
    G = H // k.shape[2]
    kr = jnp.repeat(jnp.asarray(k), G, axis=2)
    vr = jnp.repeat(jnp.asarray(v), G, axis=2)
    out = ref_ref.swa_decode_attention_ref(jnp.asarray(q), kr, vr,
                                           jnp.asarray([nv], jnp.int32))
    return np.asarray(out)


def _port(q, k, v, nv):
    nvalid = torch.tensor([nv], dtype=torch.int32)
    plain = t_swa.swa_decode_attention_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), nvalid)
    wrapped = t_ops.swa_decode_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), nv)
    assert torch.equal(plain, wrapped)      # a CPU tensor takes the plain path
    return plain.numpy()


@pytest.mark.parametrize("Dh", [64, 96])
@pytest.mark.parametrize("KV", [H, H // 2, H // 4])
@pytest.mark.parametrize("frac", ["one", "third", "all"])
@pytest.mark.parametrize("C", [40, 64, 1000, 2047])
def test_plain_matches_ref(C, frac, KV, Dh):
    nv = {"one": 1, "third": C // 3, "all": C}[frac]
    q, k, v = _inputs(C, KV, Dh, seed=C + KV + Dh)
    np.testing.assert_allclose(_port(q, k, v, nv), _ref(q, k, v, nv),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("Dh", [64, 96])
@pytest.mark.parametrize("KV", [H, H // 2, H // 4])
@pytest.mark.parametrize("C", [40, 64, 1000])
def test_plain_matches_pallas_interpret(C, KV, Dh):
    """C = 1000 is the reference test's length: Pallas tiles of 8 slots."""
    q, k, v = _inputs(C, KV, Dh, seed=7 * C + KV + Dh)
    for nv in (1, C // 3, C):
        pallas = np.asarray(ref_ops.swa_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray([nv], jnp.int32), interpret=True))
        np.testing.assert_allclose(_port(q, k, v, nv), pallas, atol=ATOL,
                                   rtol=0, err_msg=f"nvalid={nv}")


def test_all_masked_is_the_mean():
    """nvalid = 0 masks every slot: the softmax is uniform, as in Pallas."""
    q, k, v = _inputs(40, H // 2, 64)
    np.testing.assert_allclose(_port(q, k, v, 0), _ref(q, k, v, 0),
                               atol=ATOL, rtol=0)
    mean = np.repeat(v.mean(axis=1), 2, axis=1)          # [B, H, Dh]
    np.testing.assert_allclose(_port(q, k, v, 0), mean, atol=ATOL, rtol=0)


def test_wrapper_checks_its_operands():
    q = torch.zeros((2, 8, 64))
    k = torch.zeros((2, 16, 4, 64))
    nv = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="do not divide"):
        t_swa.swa_decode(q, torch.zeros((2, 16, 3, 64)),
                         torch.zeros((2, 16, 3, 64)), nv)
    with pytest.raises(TypeError, match="dtype"):
        t_swa.swa_decode(q, k.to(torch.bfloat16), k.to(torch.bfloat16), nv)
    with pytest.raises(ValueError, match="dense"):
        t_swa.swa_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         k, nv)
    with pytest.raises(TypeError, match="nvalid"):
        t_swa.swa_decode(q, k, k, nv.to(torch.int64))
    with pytest.raises(ValueError, match="shape"):
        t_swa.swa_decode(q, k[:1], k[:1], nv)
