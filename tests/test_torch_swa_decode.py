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

The card kernel splits the slot range across blocks and combines the
partials (``csrc/swa_decode.cu``); ``ref.swa_decode_splits_plain`` is that
algorithm in plain torch, held here against the reference at split counts
S in {1, 2, 7, 32} and nvalid at 0, 1, one slot short of a split boundary,
on it, and at C.  ``split_count``, ``tile_slots`` and ``smem_row`` choose
the kernel's plan on the host and are checked as pure functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
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
@pytest.mark.parametrize("frac", ["none", "one", "third", "all"])
@pytest.mark.parametrize("C", [40, 64, 1000, 2047])
def test_plain_matches_ref(C, frac, KV, Dh):
    nv = {"none": 0, "one": 1, "third": C // 3, "all": C}[frac]
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


SPLITS = [1, 2, 7, 32]
_PALLAS: dict = {}


def _chunk(C, S, tile=1):
    return -(-(-(-C // tile)) // S) * tile


def _split_nvalids(C, S):
    """0, 1, one slot short of the first split boundary, on it, and C."""
    edge = _chunk(C, S) if S > 1 else C - 1
    return [0, 1, edge - 1, edge, C]


def _splits(q, k, v, nv, S, tile=1):
    out = t_ref.swa_decode_splits_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor([nv], dtype=torch.int32), S, tile=tile)
    assert not torch.isnan(out).any(), f"nvalid={nv} S={S}: NaN"
    return out.numpy()


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("C", [40, 1000, 2047])
def test_splits_plain_matches_ref(C, S):
    """The split-and-combine model against the reference's oracle, empty
    splits (nvalid below a split's start) included: they leave no NaN."""
    q, k, v = _inputs(C, H // 4, 64, seed=3 * C + S)
    for nv in _split_nvalids(C, S):
        np.testing.assert_allclose(_splits(q, k, v, nv, S),
                                   _ref(q, k, v, nv), atol=ATOL, rtol=0,
                                   err_msg=f"nvalid={nv}")


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("C", [40, 1000])
def test_splits_plain_matches_pallas_interpret(C, S):
    """The same cases against the Pallas kernel in interpret mode."""
    q, k, v = _inputs(C, H // 2, 64, seed=11 * C)
    for nv in _split_nvalids(C, S):
        key = (C, nv)
        if key not in _PALLAS:
            _PALLAS[key] = np.asarray(ref_ops.swa_decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray([nv], jnp.int32), interpret=True))
        np.testing.assert_allclose(_splits(q, k, v, nv, S), _PALLAS[key],
                                   atol=ATOL, rtol=0, err_msg=f"nvalid={nv}")


@pytest.mark.parametrize("Dh,esize", [(96, 2), (64, 2), (64, 4), (256, 4),
                                      (100, 2)])
def test_splits_plain_with_the_kernels_tiles(Dh, esize):
    """Tile-aligned splits, as the kernel cuts them at its own tile and
    split count for a card of 132 SMs: still the reference's answer."""
    C = 1000
    q, k, v = _inputs(C, H // 4, Dh, seed=Dh)
    p = t_swa.plan(B, H // 4, C, Dh, esize, 132)
    tile, S = p["tile"], p["splits"]
    assert S > 1
    for nv in (0, 1, _chunk(C, S, tile) - 1, _chunk(C, S, tile), C):
        np.testing.assert_allclose(_splits(q, k, v, nv, S, tile),
                                   _ref(q, k, v, nv), atol=ATOL, rtol=0)


def test_splits_plain_leave_out_drops_a_split():
    """The planted fault of the chip check: one split's partial dropped."""
    q, k, v = _inputs(1000, H // 4, 64)
    nv = torch.tensor([1000], dtype=torch.int32)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), nv)
    full = t_ref.swa_decode_splits_plain(*args, 4)
    less = t_ref.swa_decode_splits_plain(*args, 4, leave_out=1)
    kept = torch.cat([torch.arange(250), torch.arange(500, 1000)])
    want = t_ref.swa_decode_attention_plain(
        args[0], args[1][:, kept], args[2][:, kept],
        torch.tensor([750], dtype=torch.int32))
    torch.testing.assert_close(less, want, atol=ATOL, rtol=0)
    assert float((full - less).abs().max()) > 1e-2


@pytest.mark.parametrize("n_sm", [1, 8, 132])
@pytest.mark.parametrize("bkv", [1, 3, 12, 128, 528, 4096])
@pytest.mark.parametrize("n_tiles", [1, 2, 17, 64, 1000])
def test_split_count(bkv, n_tiles, n_sm):
    """At least 1, at most one split a tile, no split without a tile, and
    within one wave of resident blocks once there are two splits."""
    S = t_swa.split_count(bkv, n_tiles, n_sm)
    assert 1 <= S <= n_tiles
    per = -(-n_tiles // S)
    assert (S - 1) * per < n_tiles
    assert S == 1 or per >= t_swa.SPLIT_TILES
    if S > 1:
        assert bkv * S <= t_swa.BLOCKS_PER_SM * n_sm
    if bkv >= t_swa.BLOCKS_PER_SM * n_sm:
        assert S == 1


def test_split_count_reads_no_nvalid():
    """The split plan takes the shape and the card only, so a CUDA graph
    captured at one nvalid replays right at another."""
    import inspect
    for fn in (t_swa.plan, t_swa.split_count, t_swa.tile_slots,
               t_swa.smem_row):
        assert "nvalid" not in inspect.signature(fn).parameters
    assert t_swa.split_count(128, 64, 132) == 4        # phi3 serving
    assert t_swa.split_count(1024, 64, 132) == 1       # 32 sequences


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("Dh", [1, 8, 63, 64, 96, 100, 128, 256])
def test_tile_and_row_stride(Dh, esize):
    """The tile is a power of two in [8, 64] whose rings fit the budget
    (the smallest tile excepted), rows keep their 16-byte units whole, and
    a quarter-warp's 16-byte reads land on distinct bank groups."""
    tile = t_swa.tile_slots(Dh, esize)
    assert tile in t_swa.TILES
    ld = t_swa.smem_row(Dh, esize, tile)
    assert ld >= Dh
    ring = t_swa.STAGES * 2 * tile * ld * esize
    assert tile == min(t_swa.TILES) or ring <= t_swa.RING_BYTES
    vec = 16 // esize
    if Dh % vec == 0:
        assert ld % vec == 0
        lanes = t_swa.THREADS // tile
        rows, width = max(1, 8 // lanes), min(lanes, 8)
        units = ld // vec
        banks = {(r * units + c) % 8 for r in range(rows)
                 for c in range(width)}
        assert len(banks) == rows * width


@pytest.mark.parametrize("KV", [1, 3, 4, 32])
def test_plan(KV):
    """The launch plan: the splits cover the slots with none empty, and
    the grid is its blocks."""
    for Dh, esize in ((96, 2), (64, 4), (128, 2), (256, 4)):
        for B, C in ((4, 2047), (32, 2047), (2, 40), (1, 5)):
            p = t_swa.plan(B, KV, C, Dh, esize, 132)
            assert p["tile"] == t_swa.tile_slots(Dh, esize)
            assert p["chunk"] % p["tile"] == 0
            assert (p["splits"] - 1) * p["chunk"] < C <= \
                p["splits"] * p["chunk"]
            assert p["blocks"] == B * KV * p["splits"]
    serve = t_swa.plan(4, 32, 2047, 96, 2, 132)        # phi3's decode
    assert serve["splits"] == 4 and serve["blocks"] <= 4 * 132
