"""The counter-hash mask streams of the port against
``repro.kernels.secure_agg``: uint32 integer math, so bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import secure_agg as ref
from repro_torch.kernels import secure_agg as port

_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFF, 0x10000,
                   0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def _u32(seed, n):
    rng = np.random.default_rng(seed)
    return np.concatenate([_EDGES, rng.integers(0, 2 ** 32, n,
                                                dtype=np.uint64
                                                ).astype(np.uint32)])


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def test_hash_u32_bit_exact_over_uint32_range():
    x = _u32(0, 200_000)
    want = np.asarray(ref._hash_u32(jnp.asarray(x)))
    got = port.hash_u32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, 0x7FFFFFFE, 0xFFFFFFFF])
@pytest.mark.parametrize("scale", [1.0, 0.2, 0.5])
def test_pair_stream_bit_exact(seed, scale):
    idx = _u32(1, 4096)
    pids = np.array([0, 1, 5, 1224, 65535, 0xFFFFFFFF], dtype=np.uint32)
    want = np.asarray(ref.pair_stream(jnp.asarray(pids)[:, None],
                                      jnp.asarray(idx)[None, :],
                                      jnp.uint32(seed), scale))
    got = port.pair_stream(torch.as_tensor(pids.astype(np.int64))[:, None],
                           torch.as_tensor(idx.astype(np.int64))[None, :],
                           seed, scale).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("L", [2, 7, 13])
@pytest.mark.parametrize("with_alive", [False, True])
def test_net_mask_stream_matches(L, with_alive):
    """Every signed peer term is a pair stream (bit-exact above); the net
    mask sums L of them, and XLA and torch add in different orders, so the
    sum agrees to f32 reordering: one ulp per term at |term| <= 0.3."""
    D = 509
    idx = np.arange(D, dtype=np.uint32)
    alive = (np.arange(L) % 3 != 1) if with_alive else None
    for k in range(L):
        want = np.asarray(ref.net_mask_stream(
            k, jnp.asarray(idx)[None, :], jnp.uint32(12345), 0.3, L,
            None if alive is None else jnp.asarray(alive)))[0]
        got = port.net_mask_stream(
            k, torch.arange(D), 12345, 0.3, L,
            None if alive is None else torch.as_tensor(alive)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=L * 3e-8)
        if L == 2:                       # one peer term: nothing to reorder
            assert np.array_equal(_bits(got), _bits(want)), k


def test_pair_streams_plain_enumerates_pairs_in_order():
    L, D, seed = 6, 33, 99
    s = port.pair_streams_plain(seed, L, D, 0.5)
    pid = 0
    for a in range(L):
        for b in range(a + 1, L):
            want = np.asarray(ref.pair_stream(
                jnp.uint32(pid), jnp.arange(D, dtype=jnp.uint32),
                jnp.uint32(seed), 0.5))
            assert np.array_equal(_bits(s[pid].numpy()), _bits(want))
            pid += 1
    assert pid == s.shape[0]


def test_pair_streams_wrapper_uses_plain_version_on_cpu():
    from repro_torch import kernels as K
    before = K.LAUNCHES["pair_streams"]
    out = port.pair_streams(3, 5, 17, 1.0, "cpu")
    assert torch.equal(out, port.pair_streams_plain(3, 5, 17, 1.0))
    assert K.LAUNCHES["pair_streams"] == before
