"""The round fold's launch layouts and K2's summation order, on the CPU.

K1 (``fold_norms``) and K2 (``fold_apply``) run as CUDA kernels on the
card; here their launch plans (``round_fold.norms_plan``,
``round_fold.fold_layout``) are read as the pure functions they are, the
pair walk of ``csrc/hash.cuh`` is replayed in plain python
(``ref.walk_pairs``, ``ref.alive_pairs``), and K2's regrouped order
(``ref.fold_apply_regrouped_plain``) is held against the reference's
Pallas ``fold_apply`` in interpret mode, as the reference's own tests run
it.  Inputs come from numpy.

Tolerances: f32 atol 1e-5, the reference's parity contract (the regrouped
order adds each alive pair's stream once, with weight nw[a] - nw[b],
where the reference adds it twice); the plain versions with int32 and
int64 seeds are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import round_fold as ref_rf
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import round_fold as t_rf

ATOL = 1e-5
N_SM = 132
MODES = ["none", "laplace", "mask"]


# ------------------------------------------------------------ K1's plan


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("rows", [1, 80, 500, 100000])
@pytest.mark.parametrize("D", [1, 2, 3, 509, 4096, 4097, 1 << 22])
def test_norms_plan_is_one_grid_that_covers_every_row(esize, rows, D):
    p = t_rf.norms_plan(rows, D, esize, N_SM)
    vec = 16 // esize
    if p["layout"] == "rows":
        lanes, threads = p["lanes"], p["threads"]
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert threads & (threads - 1) == 0 and 32 <= threads <= 256
        assert lanes * t_rf.LOADS * vec >= D            # one step a row
        per_block = threads // lanes
        assert p["blocks"] * per_block >= rows > (p["blocks"] - 1) * per_block
        assert p["splits"] == 1
    else:
        splits, pieces = p["splits"], p["pieces"]
        assert p["threads"] == 256 and pieces * 256 * vec >= D
        # pieces of 256 vectors dealt to the splits in turn cover the row
        # once, and every thread of every split has a full step
        dealt = sorted(i for s in range(splits)
                       for i in range(s, pieces, splits))
        assert dealt == list(range(pieces))
        assert splits == 1 or pieces >= t_rf.LOADS * splits
        # within WAVES waves unless the rows alone exceed them
        assert p["blocks"] == rows * splits
        assert p["blocks"] <= max(rows, t_rf.WAVES * N_SM *
                                  t_rf.BLOCKS_PER_SM)


@pytest.mark.parametrize("D,rows,want", [
    (1, 500, ("rows", 1, 16)), (2, 500, ("rows", 1, 16)),
    (3, 500, ("rows", 1, 16)), (4097, 1, ("split", 1, 1)),
    (8191, 1, ("split", 1, 1)), (8192, 1, ("split", 2, 2)),
    (4097, 500, ("split", 1, 500)), (1 << 22, 80, ("split", 26, 2080)),
    (1 << 22, 8, ("split", 264, 2112))])
def test_norms_plan_split_count(D, rows, want):
    """The main path's (10, 50, 2) is 500 rows a lane each, 32 a block: 16
    blocks, not one a row; 2^22 at 80 rows is 26 splits, 2,080 blocks
    (four waves of 4 a SM)."""
    p = t_rf.norms_plan(rows, D, 4, N_SM)
    assert (p["layout"], p["splits"], p["blocks"]) == want
    if D <= 3:
        assert p["lanes"] == 1 and p["threads"] == 32


def test_norms_workspace_only_with_splits():
    """No partials when one split suffices; with splits, the partials and
    one ticket a row."""
    assert t_rf.norms_workspace(500, 1) == 0
    assert t_rf.norms_workspace(80, 6) == 80 * 6 + 80


# ----------------------------------------------------- K2's pair list


@pytest.mark.parametrize("n", [2, 3, 8, 50, 91])
@pytest.mark.parametrize("chunk", [1, 7, 100, 2048])
def test_walk_pairs_visits_each_id_once_in_pair_id_order(n, chunk):
    npairs = n * (n - 1) // 2
    for lo in range(0, npairs, chunk):
        hi = min(npairs, lo + chunk)
        cells = t_ref.walk_pairs(n, lo, hi)
        assert sorted(c for c, _, _ in cells) == list(range(hi - lo))
        for c, i, j in cells:
            assert 0 <= i < j < n and t_ref.pair_id(i, j, n) == lo + c
    # the bisection inverts pair_id on every row start
    for a in range(n - 1):
        assert t_ref.pair_row(t_ref.pair_id(a, a + 1, n), n) == a
        assert t_ref.pair_row(t_ref.pair_id(a, n - 1, n), n) == a


def _alive_cases(L):
    rng = np.random.default_rng(L)
    one = np.zeros(L, bool)
    one[L // 2] = True
    every_other = np.arange(L) % 2 == 0
    one_dead = np.ones(L, bool)
    one_dead[L // 2] = False
    return {"all": np.ones(L, bool), "one_dead": one_dead,
            "every_other": every_other, "random": rng.random(L) < 0.7,
            "one_alive": one, "none": np.zeros(L, bool)}


@pytest.mark.parametrize("L", [1, 2, 8, 45, 46, 64, 91])
@pytest.mark.parametrize("chunk", [100, t_ref.PAIR_CHUNK])
def test_alive_pairs_keep_pair_id_order_and_drop_dead_pairs(L, chunk):
    """The row walk lists exactly the pairs with both ends alive, in
    pair_id's order, every slot filled (45 and 46 clients give 990 and
    1,035 pairs, 91 gives 4,095: two chunks of 2,048)."""
    for name, alive in _alive_cases(L).items():
        chunks = t_ref.alive_pairs(alive.tolist(), chunk)
        flat = [e for slots in chunks for e in slots]
        want = [(t_ref.pair_id(a, b, L), a, b) for a in range(L)
                for b in range(a + 1, L) if alive[a] and alive[b]]
        assert flat == want, name
        assert all(len(s) <= chunk for s in chunks)


# ------------------------------------------------- K2's regrouped order


def _inputs(P, L, D, seed=0, dead=(3,)):
    rng = np.random.default_rng(seed)
    nw = rng.uniform(0.1, 1.0, (P, L))
    nw[:, list(dead)] = 0.0                 # dead clients: their pairs vanish
    nw = nw / np.maximum(nw.sum(axis=1, keepdims=True), 1e-12)
    return dict(
        w=rng.standard_normal((P, D)).astype(np.float32),
        g=(3 * rng.standard_normal((P, L, D))).astype(np.float32),
        noise=(0.3 * rng.standard_normal((P, L, D))).astype(np.float32),
        ss=(0.1 * rng.uniform(0.1, 1.0, (P, L))).astype(np.float32),
        fw=rng.uniform(0.0, 1.0, (P, L)).astype(np.float32),
        nw=nw.astype(np.float32),
        seeds=((np.arange(P) * 2654435761 + 7) % 2 ** 32).astype(np.uint32))


def _torch_args(x):
    return ([torch.as_tensor(x[k]) for k in ("w", "g", "ss", "fw", "nw")],
            dict(seeds=torch.as_tensor(x["seeds"].astype(np.int64)),
                 noise=torch.as_tensor(x["noise"])))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("slices", [1, 2, 128])
def test_regrouped_order_vs_reference_pallas(mode, slices):
    """L = 8 with a dead client, against the reference's Pallas fold in
    interpret mode (block 128, so no padding enters)."""
    P, L, D = 3, 8, 128
    x = _inputs(P, L, D)
    want = ref_rf.fold_apply(
        *(jnp.asarray(x[k]) for k in ("w", "g", "ss", "fw", "nw")),
        mode=mode, sigma=0.5, seeds=jnp.asarray(x["seeds"]),
        noise=jnp.asarray(x["noise"]), block_d=128, interpret=True)
    args, kw = _torch_args(x)
    got = t_ref.fold_apply_regrouped_plain(*args, mode=mode, sigma=0.5,
                                           slices=slices, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("chunk", [100, t_ref.PAIR_CHUNK])
def test_regrouped_order_at_the_main_path_layout(chunk):
    """(10, 50, 2) in the kernel's own layout (2 features x 128 slices),
    with two dead clients, against the plain version."""
    P, L, D = 10, 50, 2
    F, S, fpt = t_rf.fold_layout(D, "mask")
    assert (F, S, fpt) == (2, 128, 1)
    x = _inputs(P, L, D, seed=5, dead=(0, 25))
    args, kw = _torch_args(x)
    want = t_rf.fold_apply_plain(*args, mode="mask", sigma=0.5, **kw)
    got = t_ref.fold_apply_regrouped_plain(*args, mode="mask", sigma=0.5,
                                           slices=S, chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("D,mode,want", [
    (1, "mask", (1, 256, 1)), (2, "none", (2, 128, 1)),
    (3, "laplace", (4, 64, 1)), (255, "mask", (256, 1, 1)),
    (256, "mask", (256, 1, 1)), (512, "mask", (256, 1, 2)),
    (1024, "mask", (256, 1, 4)), (1 << 22, "mask", (256, 1, 4)),
    (1 << 22, "none", (256, 1, 1)), (1 << 22, "laplace", (256, 1, 1))])
def test_fold_layout(D, mode, want):
    assert t_rf.fold_layout(D, mode) == want


# ------------------------------------------------------ seeds and checks


def test_fold_apply_seeds_int32_and_int64_agree():
    """Seeds at and above 2^31: as int64 values and as int32 bit patterns
    the fold is the same, and it matches the reference's uint32 seeds."""
    P, L, D = 4, 6, 40
    x = _inputs(P, L, D, seed=9, dead=(1,))
    x["seeds"] = np.array([0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 + 12345],
                          np.uint32)
    args, _ = _torch_args(x)
    s64 = torch.as_tensor(x["seeds"].astype(np.int64))
    s32 = torch.as_tensor(x["seeds"].view(np.int32))
    assert int(s32.min()) < 0                     # bit patterns, not values
    a = t_rf.fold_apply(*args, mode="mask", sigma=0.5, seeds=s64)
    b = t_rf.fold_apply(*args, mode="mask", sigma=0.5, seeds=s32)
    assert torch.equal(a, b)
    want = ref_rf.fold_apply(
        *(jnp.asarray(np.pad(x[k], [(0, 0)] * (x[k].ndim - 1) + [(0, 88)]))
          if k in ("w", "g") else jnp.asarray(x[k])
          for k in ("w", "g", "ss", "fw", "nw")),
        mode="mask", sigma=0.5, seeds=jnp.asarray(x["seeds"]), block_d=128,
        interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(want)[:, :D], atol=ATOL,
                               rtol=0)


def test_fold_apply_checks_every_operand():
    P, L, D = 2, 3, 8
    g = torch.zeros((P, L, D))
    w = torch.zeros((P, D))
    ss = torch.zeros((P, L))
    with pytest.raises(TypeError, match="stepscale: dtype"):
        t_rf.fold_apply(w, g, ss.double(), ss, ss)
    with pytest.raises(ValueError, match="fold_wn: shape"):
        t_rf.fold_apply(w, g, ss, ss[:, :2], ss)
    with pytest.raises(ValueError, match="w: must be contiguous"):
        t_rf.fold_apply(torch.zeros((D, P)).T, g, ss, ss, ss)
    with pytest.raises(TypeError, match="seeds: dtype"):
        t_rf.fold_apply(w, g, ss, ss, ss, mode="mask",
                        seeds=torch.zeros(P))
    with pytest.raises(TypeError, match="noise: dtype"):
        t_rf.fold_apply(w, g, ss, ss, ss, mode="laplace",
                        noise=g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="laplace mode needs"):
        t_rf.fold_apply(w, g, ss, ss, ss, mode="laplace")
    with pytest.raises(ValueError, match="no kernel for device"):
        t_rf.fold_norms(g.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        t_rf.fold_norms(g[0])
