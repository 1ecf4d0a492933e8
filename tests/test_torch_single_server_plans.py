"""K5's and K6's launch plans and summation orders, on the CPU.

K6 ``clip_accum`` and K5 ``secure_agg_mean`` run as CUDA kernels on the
card; here their launch plans (``clip_accum.plan``, ``secure_agg.plan``)
are read as the pure functions they are, over every L and D the wrappers
take, and the kernels' orders of summation are held against the
reference's Pallas kernels in interpret mode (``backend="pallas"``) and
its jnp oracles (``backend="ref"``), as the reference's own tests run
them.  Inputs come from numpy.

Tolerances: K6's blocked order (``ref.clip_accum_blocked_plain``) within
atol = rtol = 1e-5, the reference's clip_accum limit; K5's pair-major
order (the plain version, which the kernel follows) within the card's
limit ``max(1e-5, L scale 2^-22)`` of the Pallas kernel, whose net masks
add each pair's stream twice, in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.kernels import ops as ref_ops
from repro_torch.kernels import clip_accum as t_ca
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import secure_agg as t_sa

N_SM = 132
SM_SMEM = 233472       # shared memory of an H100 SM (228 KB)
SMEM_RESERVED = 1024   # a block's share the card reserves for itself
STATIC_SMEM = 256      # K6's own: 8 warps x 8 rows of sums
TOL_CLIP = 1e-5
SEED = 17


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    # the reference's block autotuner times every candidate in interpret
    # mode; its choice does not change the values, so take the largest
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "0")


def k5_atol(L, scale):
    """The card's K5 limit (chip_smoke.py k5_atol)."""
    return max(1e-5, L * scale * 2.0 ** -22)


# ------------------------------------------------------------ K6's plan


def _check_clip_plan(L, D, esize, n_sm, per_sm):
    p = t_ca.plan(L, D, esize, n_sm, per_sm)
    tile, tiles, grid = p["tile"], p["tiles"], p["grid"]
    assert tile == t_ca.THREADS * 16 // esize
    assert tiles * tile >= D > (tiles - 1) * tile
    # within the co-resident blocks, each owning a tile at least
    assert 1 <= grid <= min(tiles, n_sm * per_sm)
    # every tile, and so every feature, in exactly one block
    owned = []
    for b in range(grid):
        first, second = t_ca.tile_order(p, b)
        assert first and second == first[::-1]
        owned += first
    assert sorted(owned) == list(range(tiles))
    # the resident tiles and the coefficients within the shared memory a
    # block may take, and the plan's blocks within an SM's
    res = p["resident"]
    assert 0 <= res <= min(t_ca.MAX_RESIDENT, -(-tiles // grid))
    assert p["smem"] == -(-L // 4) * 16 + res * L * t_ca.THREADS * 16
    assert p["smem"] <= t_ca.SMEM_BLOCK
    assert t_ca.BLOCKS_PER_SM * (p["smem"] + STATIC_SMEM +
                                 SMEM_RESERVED) <= SM_SMEM
    # as many resident tiles as fit, up to the block's own
    slot = L * t_ca.THREADS * 16
    if res < min(t_ca.MAX_RESIDENT, -(-tiles // grid)):
        assert p["smem"] + slot > t_ca.SMEM_BLOCK
    return p


@settings(max_examples=60, deadline=None)
@given(L=st.integers(1, t_ca.MAX_CLIENTS), D=st.integers(1, 1 << 24),
       esize=st.sampled_from([2, 4]), per_sm=st.integers(1, 2))
def test_clip_plan_covers_each_feature_once_within_the_card(L, D, esize,
                                                            per_sm):
    _check_clip_plan(L, D, esize, N_SM, per_sm)


@pytest.mark.parametrize("L,D,esize,grid,resident", [
    (8, 8192, 4, 8, 1),           # the micro row: all of g on chip
    (6, 509, 4, 1, 1),
    (8, 1 << 22, 4, 264, 3),      # past the L2: a fifth of g on chip
    (8, 1 << 22, 2, 264, 3),
    (1, 7, 4, 1, 1),
    (12288, 64, 4, 1, 0)])        # the coefficients alone
def test_clip_plan_at_the_checked_shapes(L, D, esize, grid, resident):
    p = _check_clip_plan(L, D, esize, N_SM, t_ca.BLOCKS_PER_SM)
    assert (p["grid"], p["resident"]) == (grid, resident)


def test_clip_resident_boundary():
    """At L = 8 a block keeps three tiles of every row: 792 tiles of 1024
    f32 on 264 blocks.  One more tile column crosses the boundary."""
    p = t_ca.plan(8, 792 * 1024, 4, N_SM)
    assert p["grid"] == 264 and p["resident"] == 3 and p["tiles"] == 792
    q = t_ca.plan(8, 792 * 1024 + 1, 4, N_SM)
    assert q["resident"] == 3 and q["tiles"] == 793
    assert t_ca.hbm_bytes(p, 8, 792 * 1024, 4) == (9 * 792 * 1024) * 4
    # the extra tile is read twice
    assert t_ca.hbm_bytes(q, 8, 792 * 1024 + 1, 4) == \
        (8 * (792 * 1024 + 1 + 1) + 792 * 1024 + 1) * 4


def test_clip_hbm_bytes_between_one_and_two_reads():
    for L, D in ((8, 8192), (6, 509), (8, 1 << 22), (64, 1 << 20)):
        p = t_ca.plan(L, D, 4, N_SM)
        once = (L * D + D) * 4
        got = t_ca.hbm_bytes(p, L, D, 4)
        assert once <= got <= once + L * D * 4
    p = t_ca.plan(8, 1 << 22, 4, N_SM)
    # 792 of 4096 tiles stay on chip: g is read 1.81 times
    assert t_ca.hbm_bytes(p, 8, 1 << 22, 4) == \
        (8 * ((1 << 22) + (4096 - 792) * 1024) + (1 << 22)) * 4


# ------------------------------------------------------------ K5's plan


@settings(max_examples=80, deadline=None)
@given(L=st.integers(1, t_sa.MAX_CLIENTS), D=st.integers(1, 1 << 24),
       esize=st.sampled_from([2, 4]))
def test_secure_agg_plan_covers_each_feature_once(L, D, esize):
    p = t_sa.plan(L, D, esize, N_SM)
    fpt, threads, blocks = p["fpt"], p["threads"], p["blocks"]
    assert fpt in (1, 2, 4, 8)
    assert threads in (64, 128, 256)
    # thread i owns features [i fpt, i fpt + fpt) below D: the last block
    # holds the last feature, and no block starts past D
    per_block = threads * fpt
    assert blocks * per_block >= D > (blocks - 1) * per_block
    # eight features a thread unless D is too small to fill the card, or
    # (f32) not a multiple of eight: then one vector
    one_vector = fpt * esize == 16 and D % t_sa.FEATURES != 0
    if (fpt < t_sa.FEATURES and not one_vector) or threads < t_sa.THREADS:
        assert -(-D // (2 * per_block)) < N_SM
    if blocks < N_SM:
        assert fpt == 1 and threads == t_sa.MIN_THREADS
    # more than one 16-byte vector a thread only when D holds whole groups:
    # no thread's vectors reach past D
    if fpt * esize > 16:
        assert D % fpt == 0
    assert p["smem"] == L * (L - 1) // 2 * 4 <= 227 * 1024


@pytest.mark.parametrize("L,D,esize,want", [
    (8, 8192, 4, (1, 64, 128)),       # the micro row fills the card
    (8, 1 << 22, 4, (8, 256, 2048)),
    (8, 1 << 22, 2, (8, 256, 2048)),
    (5, 1000, 4, (1, 64, 16)),
    (64, 256, 4, (1, 64, 4)),
    (8, 1000004, 4, (4, 256, 977)),   # D = 4 mod 8: one vector a thread
    (8, 270340, 4, (4, 256, 265)),
    (8, 1000008, 4, (8, 256, 489))])
def test_secure_agg_plan_at_the_checked_shapes(L, D, esize, want):
    p = t_sa.plan(L, D, esize, N_SM)
    assert (p["fpt"], p["threads"], p["blocks"]) == want


def _grouped_mean(upd, seed, scale, fpt):
    """K5's kernel at ``fpt`` features a thread, in plain torch: each
    thread's group of features summed over clients in order, each pair's
    stream added and taken away in pair order.  Its loads are the
    launcher's choice: 16-byte vectors when the group fills whole ones and
    D is a multiple of both the vector and the group (the aligned build),
    single elements below D otherwise.  Rows are indexed with index
    tensors, so a load past the end of a row raises."""
    L, D = upd.shape
    vec = 16 // upd.element_size()
    vector = fpt % vec == 0 and D % max(fpt, vec) == 0
    u = upd.to(torch.float32)
    out = torch.full((D,), float("nan"))
    for d0 in range(0, D, fpt):
        if vector:
            idx = torch.cat([torch.arange(d, d + vec)
                             for d in range(d0, d0 + fpt, vec)])
        else:
            idx = torch.arange(d0, min(d0 + fpt, D))
        acc = torch.zeros(len(idx))
        for k in range(L):
            acc = acc + u[k][idx]
        for pid in range(L * (L - 1) // 2):
            s = t_sa.pair_stream(pid, idx, seed, scale)
            acc = acc + s - s
        out[idx] = acc / L
    return out.to(upd.dtype)


@pytest.mark.parametrize("fpt,dtype", [(4, torch.float32),
                                       (8, torch.float32),
                                       (8, torch.bfloat16),
                                       (2, torch.float32)])
@pytest.mark.parametrize("D", [1, 7, 1001, 1004, 2048, 4099])
def test_features_a_thread_on_ragged_d(fpt, dtype, D):
    L, scale = 5, 0.7
    upd = torch.tensor(np.random.default_rng(D).standard_normal((L, D)),
                       dtype=torch.float32).to(dtype)
    seed = torch.tensor([SEED])
    got = _grouped_mean(upd, SEED, scale, fpt)
    want = t_ref.secure_agg_mean_plain(upd, seed, scale)
    tol = k5_atol(L, scale) if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=0 if dtype == torch.float32
                               else 2e-2)


# ----------------------------------------- the orders against the reference


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("L,D", [(6, 509), (3, 1000), (8, 2049), (1, 130)])
@pytest.mark.parametrize("grid", [1, 2, 3, 7])
@pytest.mark.parametrize("bound", [0.5, 100.0])
def test_clip_blocked_order_vs_reference(backend, L, D, grid, bound):
    g = 3 * np.random.default_rng(L * D + grid).standard_normal((L, D))
    g = g.astype(np.float32)
    tiles = -(-D // (32 * 4))                 # 32-thread blocks: more tiles
    want = ref_ops.clip_accum(jnp.asarray(g), bound, backend=backend)
    got = t_ref.clip_accum_blocked_plain(torch.tensor(g), bound,
                                         min(grid, tiles), threads=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CLIP,
                               rtol=TOL_CLIP)


@pytest.mark.parametrize("L,D", [(6, 509), (8, 8192)])
def test_clip_blocked_order_at_the_card_plan(L, D):
    g = 3 * np.random.default_rng(D).standard_normal((L, D))
    g = g.astype(np.float32)
    p = t_ca.plan(L, D, 4, N_SM)
    want = ref_ops.clip_accum(jnp.asarray(g), 0.5, backend="pallas")
    got = t_ref.clip_accum_blocked_plain(torch.tensor(g), 0.5, p["grid"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_CLIP,
                               rtol=TOL_CLIP)


@pytest.mark.parametrize("L", [2, 8, 13])
def test_pair_major_order_vs_pallas_at_scale_2_20(L):
    """The plain version's order, each pair's stream once a feature,
    against the reference's Pallas kernel (net masks: each stream twice)
    at scale 2^20, where the cancelled masks leave f32 rounding far above
    summation order: within the limit the card holds K5 to."""
    D, scale = 1024, 2.0 ** 20
    upd = np.random.default_rng(L).standard_normal((L, D)).astype(np.float32)
    seed = np.array([SEED], np.uint32)
    want = ref_ops.secure_agg_mean(jnp.asarray(upd), jnp.asarray(seed),
                                   scale=scale, backend="pallas")
    got = t_ref.secure_agg_mean_plain(torch.tensor(upd),
                                      torch.tensor(seed.astype(np.int64)),
                                      scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=k5_atol(L, scale), rtol=0)
    # the masks were applied on both sides: neither is the plain mean
    order = L * float(np.abs(upd).max()) * 2.0 ** -24
    assert float(np.abs(got.numpy() - upd.mean(0)).max()) > 10 * order
