"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one (as on a CPU-only machine).  This file imports
neither jax nor the reference, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: f32 atol 1e-5 (the reference's parity contract), squared norms
rtol 1e-5, bf16 fold outputs atol = rtol = 3e-2 (about two bf16 ulps at
|psi| < 4), bf16 attention outputs rtol 1e-2 and atol 2^-8 max|plain| (one
bf16 ulp of each value), hash streams exactly equal; every kernel repeats
bit for bit.  The single-server kernels: K5 ``secure_agg_mean`` within atol
max(1e-5, L scale 2^-22) (its masks cancel in another order than the plain
version's), K6 ``clip_accum`` atol = rtol = 1e-5 and K7
``laplace_transform`` atol 1e-6 (the reference's own limits), all three
atol = rtol = 3e-2 in bf16, or, in the K5 and K6 redesign's tests, rtol
1e-2 and atol 2^-8 max|plain| (one bf16 ulp, as chip_smoke.py holds them).
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels import clip_accum as ca
from repro_torch.kernels import graph_combine as gc
from repro_torch.kernels import laplace as lp
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import round_fold as rf
from repro_torch.kernels import secure_agg as sa
from repro_torch.kernels import swa_decode as swa
from repro_torch.kernels.common import raw_stream

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.parametrize("P,L,D", [(10, 50, 2), (3, 13, 509), (2, 8, 40000)])
def test_fold_norms_matches_plain(cuda, P, L, D):
    g = torch.randn((P, L, D), generator=cuda, device="cuda")
    before = K.LAUNCHES["fold_norms"]
    a, b = rf.fold_norms(g), rf.fold_norms(g)
    assert K.LAUNCHES["fold_norms"] == before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, rf.fold_norms_plain(g), atol=0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["none", "laplace", "mask"])
@pytest.mark.parametrize("per_client", [False, True])
@pytest.mark.parametrize("P,L,D", [(10, 50, 2), (3, 13, 509)])
def test_fold_apply_matches_plain(cuda, mode, per_client, P, L, D):
    w = torch.randn((P, L, D) if per_client else (P, D), generator=cuda,
                    device="cuda")
    g = torch.randn((P, L, D), generator=cuda, device="cuda")
    noise = torch.randn((P, L, D), generator=cuda, device="cuda")
    ss = 0.1 * torch.rand((P, L), generator=cuda, device="cuda")
    fw = torch.rand((P, L), generator=cuda, device="cuda")
    nw = torch.rand((P, L), generator=cuda, device="cuda")
    nw[:, 1] = 0.0
    nw = nw / nw.sum(dim=1, keepdim=True)     # survivor-mean noise weights
    seeds = torch.arange(P, device="cuda") * 977 + 3
    kw = dict(mode=mode, sigma=0.5, seeds=seeds, noise=noise)
    a = rf.fold_apply(w, g, ss, fw, nw, **kw)
    assert torch.equal(a, rf.fold_apply(w, g, ss, fw, nw, **kw))
    torch.testing.assert_close(a, rf.fold_apply_plain(w, g, ss, fw, nw, **kw),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 3, 2 ** 14 - 1, 2 ** 14, 2 ** 14 + 1,
                               40000])
def test_fold_norms_layouts(cuda, dtype, D):
    """Both layouts of K1's plan: a lane a row (D = 1, 3), one block a row
    and 3-9 splits a row with the last block adding the partials."""
    P, L = 3, 5
    g = torch.randn((P, L, D), generator=cuda, device="cuda").to(dtype)
    a = rf.fold_norms(g)
    assert torch.equal(a, rf.fold_norms(g))
    torch.testing.assert_close(a, rf.fold_norms_plain(g), atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [509, 4097, 40001])
def test_fold_norms_unaligned_rows(cuda, dtype, D):
    """g[1:] of a [rows, D] tensor with D odd: contiguous, but no row
    starts on a 16-byte boundary, so each has a scalar head and tail."""
    P, L = 2, 4
    base = torch.randn((P * L + 1, D), generator=cuda, device="cuda").to(dtype)
    g = base[1:].view(P, L, D)
    assert g.is_contiguous() and g.data_ptr() % 16
    a = rf.fold_norms(g)
    assert torch.equal(a, rf.fold_norms(g))
    torch.testing.assert_close(a, rf.fold_norms_plain(g), atol=0, rtol=1e-5)


def _mask_weights(cuda, P, L, alive):
    nw = torch.rand((P, L), generator=cuda, device="cuda") + 0.1
    if alive == "one_dead":
        nw[:, L // 2] = 0.0
    elif alive == "one_alive":
        nw[:, 1:] = 0.0
    elif alive == "none":
        nw.zero_()
    return nw / torch.clamp(nw.sum(dim=1, keepdim=True), min=1e-12)


@pytest.mark.parametrize("alive", ["one_dead", "one_alive", "none"])
@pytest.mark.parametrize("L", [1, 2, 45, 46, 64, 91])
@pytest.mark.parametrize("D", [2, 128, 129, 600, 1027])
def test_fold_apply_mask_pairs(cuda, alive, L, D):
    """K2's mask mode: pair slices at D <= 128, one thread a feature at
    129, two and four features a thread at 600 and 1027; 45, 46 and 91
    clients give 990, 1,035 and 4,095 pairs (two chunks of 2,048)."""
    P = 3
    w = torch.randn((P, D), generator=cuda, device="cuda")
    g = torch.randn((P, L, D), generator=cuda, device="cuda")
    ss = 0.1 * torch.rand((P, L), generator=cuda, device="cuda")
    fw = torch.rand((P, L), generator=cuda, device="cuda")
    fw = fw / fw.sum(dim=1, keepdim=True)     # normalized, as the round folds
    nw = _mask_weights(cuda, P, L, alive)
    seeds = torch.arange(P, device="cuda") * 2654435761 + 7
    kw = dict(mode="mask", sigma=0.5, seeds=seeds)
    a = rf.fold_apply(w, g, ss, fw, nw, **kw)
    assert torch.equal(a, rf.fold_apply(w, g, ss, fw, nw, **kw))
    torch.testing.assert_close(a, rf.fold_apply_plain(w, g, ss, fw, nw, **kw),
                               atol=1e-5, rtol=0)


def test_fold_apply_seed_dtypes(cuda):
    """Seeds read as stored: int64 values at and above 2^31 and their
    int32 bit patterns give the same bits."""
    P, L, D = 4, 9, 300
    w = torch.randn((P, D), generator=cuda, device="cuda")
    g = torch.randn((P, L, D), generator=cuda, device="cuda")
    ss = 0.1 * torch.rand((P, L), generator=cuda, device="cuda")
    nw = _mask_weights(cuda, P, L, "one_dead")
    s64 = torch.tensor([0, 2 ** 31, 2 ** 32 - 1, 2 ** 31 + 12345],
                       device="cuda")
    s32 = torch.where(s64 >= 2 ** 31, s64 - 2 ** 32, s64).to(torch.int32)
    a = rf.fold_apply(w, g, ss, ss, nw, mode="mask", sigma=0.5, seeds=s64)
    assert torch.equal(a, rf.fold_apply(w, g, ss, ss, nw, mode="mask",
                                        sigma=0.5, seeds=s32))
    torch.testing.assert_close(a, rf.fold_apply_plain(
        w, g, ss, ss, nw, mode="mask", sigma=0.5, seeds=s64),
        atol=1e-5, rtol=0)


def test_round_fold_graph_replay(cuda):
    """ops.round_fold captured in a CUDA graph at a width where K1 splits
    each row (8 rows x 9 splits): each replay finds new gradients and
    must give the eager result, which it can only if the last block of
    every row reset the row's ticket in the replay before."""
    P, L, D = 2, 4, 40000
    assert rf.norms_plan(P * L, D, 4, 132)["splits"] > 1
    w = torch.randn((P, D), generator=cuda, device="cuda")
    g = torch.randn((P, L, D), generator=cuda, device="cuda")
    seeds = torch.tensor([3, 2 ** 31 + 5], device="cuda")
    kw = dict(mu=0.1, bound=50.0, mode="mask", sigma=0.5, seeds=seeds)
    ops.round_fold(w, g, **kw)                          # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        psi, sq = ops.round_fold(w, g, **kw)
    for _ in range(3):
        g.copy_(torch.randn((P, L, D), generator=cuda, device="cuda"))
        psi.zero_()
        sq.zero_()
        graph.replay()
        torch.cuda.synchronize()
        want_psi, want_sq = ops.round_fold(w, g, **kw)
        assert torch.equal(sq, want_sq) and torch.equal(psi, want_psi)
        torch.testing.assert_close(sq, rf.fold_norms_plain(g), atol=0,
                                   rtol=1e-5)


@pytest.mark.parametrize("variant", ["g", "none", "gate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 2, 3, 5, 509, 40001, 8192])
@pytest.mark.parametrize("layout", ["A", "psi+1"])
def test_graph_combine_layouts(cuda, variant, dtype, D, layout):
    """A passed as stored, untransposed (the kernel reads its transpose),
    and psi one element off a 16-byte boundary (the element-wise path)."""
    P = 10
    A = torch.rand((P, P), generator=cuda, device="cuda")
    psi = torch.randn((P, D), generator=cuda, device="cuda").to(dtype)
    if layout == "psi+1":
        off = torch.empty(P * D + 1, dtype=dtype, device="cuda")[1:]
        psi = off.view(P, D).copy_(psi)
        assert psi.data_ptr() % 16
    g = None if variant == "none" else torch.randn(
        (P, D), generator=cuda, device="cuda").to(dtype)
    cache = gate = None
    if variant == "gate":
        cache = torch.randn((P, D), generator=cuda, device="cuda").to(dtype)
        gate = (torch.arange(P, device="cuda") % 3 != 0)
    before = K.LAUNCHES["graph_combine"]
    a = ops.graph_combine(A, psi, g, cache=cache, gate=gate)
    assert K.LAUNCHES["graph_combine"] == before + 1
    assert torch.equal(a, ops.graph_combine(A, psi, g, cache=cache,
                                            gate=gate))
    want = gc.graph_combine_plain(
        A, psi, g, cache=cache,
        gate=None if gate is None else gate.float())
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else \
        dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(a.float(), want.float(), **tol)


@pytest.mark.parametrize("variant", ["g", "none", "gate"])
@pytest.mark.parametrize("P,D", [(10, 2), (7, 509)])
def test_graph_combine_matches_plain(cuda, variant, P, D):
    A = torch.rand((P, P), generator=cuda, device="cuda")
    psi = torch.randn((P, D), generator=cuda, device="cuda")
    g = None if variant == "none" else torch.randn((P, D), generator=cuda,
                                                   device="cuda")
    cache = gate = None
    if variant == "gate":
        cache = torch.randn((P, D), generator=cuda, device="cuda")
        gate = (torch.arange(P, device="cuda") % 2).float()
    a = gc.graph_combine(A, psi, g, cache=cache, gate=gate)
    assert torch.equal(a, gc.graph_combine(A, psi, g, cache=cache,
                                           gate=gate))
    torch.testing.assert_close(
        a, gc.graph_combine_plain(A, psi, g, cache=cache, gate=gate),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_pair_streams_bit_exact(cuda, seed):
    got = sa.pair_streams(seed, 13, 1000, 0.5, "cuda")
    assert torch.equal(got, sa.pair_streams_plain(seed, 13, 1000, 0.5,
                                                  "cuda"))


def test_main_path_uses_the_kernels(cuda):
    from repro_torch import rng
    from repro_torch.configs.base import GFLConfig
    from repro_torch.core.simulate import generate_problem, run_gfl
    prob = generate_problem(rng(0, "cuda"), P=4, K=6, N=20)
    cfg = GFLConfig(num_servers=4, clients_per_server=6, privacy="hybrid",
                    topology="ring", use_kernels=True)
    K.reset_launches()
    msd, _ = run_gfl(prob, cfg, iters=3, batch_size=5)
    assert K.LAUNCHES["fold_norms"] == K.LAUNCHES["fold_apply"] == 3
    assert K.LAUNCHES["graph_combine"] == 3
    assert msd.shape == (3,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,C,Dh", [
    (2, 8, 4, 1000, 64),      # the reference test's shape
    (4, 9, 3, 1064, 64),      # smollm's GQA layout
    (2, 4, 4, 2047, 96),      # phi3's head dim, odd C
    (1, 8, 1, 130, 100),      # Dh not a multiple of 16 bytes: scalar loads
    (3, 2, 2, 5, 256)])       # fewer slots than a tile, the widest head
def test_swa_decode_matches_plain(cuda, dtype, B, H, KV, C, Dh):
    q = torch.randn((B, H, Dh), generator=cuda, device="cuda").to(dtype)
    # a layer slice of a [L, B, C, KV, Dh] cache, as decode passes it
    k = torch.randn((2, B, C, KV, Dh), generator=cuda,
                    device="cuda").to(dtype)[1]
    v = torch.randn((2, B, C, KV, Dh), generator=cuda,
                    device="cuda").to(dtype)[1]
    for nv in (1, C // 3 + 1, C, C + 5, 0):
        nvalid = torch.tensor([nv], dtype=torch.int32, device="cuda")
        before = K.LAUNCHES["swa_decode"]
        a = swa.swa_decode(q, k, v, nvalid)
        assert K.LAUNCHES["swa_decode"] == before + 1
        assert torch.equal(a, swa.swa_decode(q, k, v, nvalid))
        want = swa.swa_decode_attention_plain(q, k, v, nvalid).float()
        # bf16: one ulp of each value, half an ulp at the top of the range
        tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else \
            dict(atol=float(want.abs().max()) * 2.0 ** -8, rtol=1e-2)
        torch.testing.assert_close(a.float(), want, **tol)


def _swa_inputs(gen, dtype, B, H, KV, C, Dh):
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, C, KV, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, C, KV, Dh), generator=gen, device="cuda").to(dtype)
    return q, k, v


def _swa_tol(want):
    if want.dtype == torch.float32:
        return dict(atol=1e-5, rtol=0)
    return dict(atol=float(want.float().abs().max()) * 2.0 ** -8, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,C,Dh", [
    (4, 32, 32, 2047, 96),    # phi3's serving shape: 4 splits
    (2, 8, 4, 1000, 64),      # many short splits
    (4, 9, 3, 1064, 64),      # smollm's GQA layout
    (1, 8, 1, 130, 100)])     # the element-wise copies
def test_swa_decode_split_boundaries(cuda, dtype, B, H, KV, C, Dh):
    """nvalid at the split boundaries, none and one slot, every slot: the
    kernel, its split model and the plain version agree, and reruns are
    bitwise equal."""
    q, k, v = _swa_inputs(cuda, dtype, B, H, KV, C, Dh)
    plan = swa.plan(B, KV, C, Dh, q.element_size(),
                    torch.cuda.get_device_properties(0).multi_processor_count)
    tile, splits, chunk = plan["tile"], plan["splits"], plan["chunk"]
    edges = sorted({e for s in range(1, splits) for e in
                    (s * chunk - 1, s * chunk, s * chunk + 1)})
    for nv in [0, 1, C, *edges]:
        nvalid = torch.tensor([nv], dtype=torch.int32, device="cuda")
        a = swa.swa_decode(q, k, v, nvalid)
        assert torch.equal(a, swa.swa_decode(q, k, v, nvalid)), nv
        want = swa.swa_decode_attention_plain(q, k, v, nvalid)
        torch.testing.assert_close(a.float(), want.float(), **_swa_tol(want),
                                   msg=f"nvalid={nv}")
        model = ref.swa_decode_splits_plain(q, k, v, nvalid, splits,
                                            tile=tile)
        torch.testing.assert_close(model.float(), want.float(),
                                   **_swa_tol(want), msg=f"model nv={nv}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_decode_graph_replay(cuda, dtype):
    """Captured at nvalid = C/3, replayed after nvalid is set in place to
    C: the split count reads the shape only, so the replay is right."""
    B, H, KV, C, Dh = 4, 32, 32, 2047, 96
    q, k, v = _swa_inputs(cuda, dtype, B, H, KV, C, Dh)
    nvalid = torch.tensor([C // 3], dtype=torch.int32, device="cuda")
    swa.swa_decode(q, k, v, nvalid)                     # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = swa.swa_decode(q, k, v, nvalid)
    graph.replay()
    torch.cuda.synchronize()
    want = swa.swa_decode_attention_plain(q, k, v, nvalid)
    torch.testing.assert_close(out.float(), want.float(), **_swa_tol(want))
    nvalid.fill_(C)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    want = swa.swa_decode_attention_plain(q, k, v, nvalid)
    torch.testing.assert_close(out.float(), want.float(), **_swa_tol(want))
    assert torch.equal(out, swa.swa_decode(q, k, v, nvalid))


def test_swa_decode_strided_batch(cuda):
    # k/v with a batch stride larger than C * KV * Dh (every other row)
    base = torch.randn((4, 300, 2, 64), generator=cuda, device="cuda")
    k, v = base[::2], base[1::2]
    q = torch.randn((2, 4, 64), generator=cuda, device="cuda")
    nvalid = torch.tensor([257], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(swa.swa_decode(q, k, v, nvalid),
                               swa.swa_decode_attention_plain(q, k, v, nvalid),
                               atol=1e-5, rtol=0)


def test_serve_path_uses_the_kernel(cuda):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = Model.init(cfg, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=cuda,
                         device="cuda")
    full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :96])
    K.reset_launches()
    for t in range(4):
        logits, cache = model.decode_step(toks[:, 96 + t], cache)
        torch.testing.assert_close(logits, full[:, 96 + t], atol=2e-4,
                                   rtol=2e-4)
    assert K.LAUNCHES["swa_decode"] == 4 * cfg.num_layers


def _single_tol(dtype, f32_tol):
    return f32_tol if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D", [(8, 8192), (5, 1000), (64, 256), (1, 7)])
def test_secure_agg_mean_matches_plain(cuda, dtype, L, D):
    upd = torch.randn((L, D), generator=cuda, device="cuda").to(dtype)
    for seed, scale in (([7], 0.7), ([-1640531527], 1.0)):
        seed = torch.tensor(seed, dtype=torch.int32, device="cuda")
        before = K.LAUNCHES["secure_agg_mean"]
        a = ops.secure_agg_mean(upd, seed, scale)
        assert K.LAUNCHES["secure_agg_mean"] == before + 1
        assert torch.equal(a, sa.secure_agg_mean(upd, seed, scale))
        tol = _single_tol(dtype, dict(atol=max(1e-5, L * scale * 2 ** -22),
                                      rtol=0))
        torch.testing.assert_close(
            a.float(), ref.secure_agg_mean_plain(upd, seed, scale).float(),
            **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [2, 8, 64, 256])
@pytest.mark.parametrize("D", [4099, 1 << 18])
def test_secure_agg_mean_clients_and_ragged_d(cuda, dtype, L, D):
    """Pair-major hashing at L up to the limit, D ragged against the
    features a thread (4099) and wide enough for a 16-byte vector a thread
    (2^18); int32 and int64 seeds read as stored agree bit for bit."""
    upd = torch.randn((L, D), generator=cuda, device="cuda").to(dtype)
    want = ref.secure_agg_mean_plain(
        upd, torch.tensor([2 ** 31 + 5], device="cuda"), 0.7).float()
    outs = []
    for seed in (torch.tensor([2 ** 31 + 5], device="cuda"),
                 torch.tensor([-2 ** 31 + 5], dtype=torch.int32,
                              device="cuda")):
        before = K.LAUNCHES["secure_agg_mean"]
        a = sa.secure_agg_mean(upd, seed, 0.7)
        assert K.LAUNCHES["secure_agg_mean"] == before + 1
        assert torch.equal(a, sa.secure_agg_mean(upd, seed, 0.7))
        outs.append(a)
    assert torch.equal(outs[0], outs[1])
    tol = dict(atol=max(1e-5, L * 0.7 * 2 ** -22), rtol=0) \
        if dtype == torch.float32 else \
        dict(atol=float(want.abs().max()) * 2.0 ** -8, rtol=1e-2)
    torch.testing.assert_close(outs[0].float(), want, **tol)


def test_secure_agg_mean_applies_the_masks(cuda):
    # at scale 2^20 the cancelled masks leave f32 rounding far above the
    # summation-order noise of an unmasked mean
    upd = torch.randn((8, 4096), generator=cuda, device="cuda")
    seed = torch.tensor([7], dtype=torch.int64, device="cuda")
    a = sa.secure_agg_mean(upd, seed, 2.0 ** 20)
    assert float((a - upd.mean(0)).abs().max()) > 1e-3
    torch.testing.assert_close(
        a, ref.secure_agg_mean_plain(upd, seed, 2.0 ** 20), atol=2.0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D", [(8, 8192), (6, 509), (2, 40000)])
def test_clip_accum_matches_plain(cuda, dtype, L, D):
    g = (3 * torch.randn((L, D), generator=cuda, device="cuda")).to(dtype)
    for bound in (0.5, 100.0):
        before = dict(K.LAUNCHES)
        a = ops.clip_accum(g, bound)
        # one cooperative launch runs both passes: no K1 launch
        assert K.LAUNCHES["clip_accum"] == before["clip_accum"] + 1
        assert K.LAUNCHES["fold_norms"] == before["fold_norms"]
        assert torch.equal(a, ca.clip_accum(g, bound))
        torch.testing.assert_close(
            a.float(), ref.clip_accum_plain(g, bound).float(),
            **_single_tol(dtype, dict(atol=1e-5, rtol=1e-5)))


def _n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("D", [1000004, 270340])
def test_secure_agg_mean_last_vector_past_d(cuda, D):
    """f32 with D = 4 mod 8 and 16-byte aligned rows, wide enough for eight
    features a thread, whose second vector would lie past D in the last
    thread: the plan takes one vector a thread.  Runs twice, bitwise equal,
    within K5's limit of the plain version; and the launcher, handed eight
    features a thread, takes the element build, with the same result bit
    for bit (each feature's order of additions does not depend on the
    grouping)."""
    L, scale = 8, 0.7
    assert D % 8 == 4 and sa.plan(L, D, 4, _n_sm())["fpt"] == 4
    upd = torch.randn((L, D), generator=cuda, device="cuda")
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    a = sa.secure_agg_mean(upd, seed, scale)
    assert torch.equal(a, sa.secure_agg_mean(upd, seed, scale))
    torch.testing.assert_close(
        a, ref.secure_agg_mean_plain(upd, seed, scale),
        atol=max(1e-5, L * scale * 2 ** -22), rtol=0)
    word = sa._plan_word(upd.device, L, D, upd.dtype)
    eight = (word & ~0b1100) | 3 << 2                # log2 8 features
    out = torch.empty_like(a)
    _build.check(_build.function("secure_agg_mean")(
        upd.data_ptr(), seed.data_ptr(), scale, out.data_ptr(), D, eight,
        raw_stream(0)), "secure_agg_mean")
    torch.cuda.synchronize()
    assert torch.equal(out, a)


def _clip_check(g, bound=0.5):
    """One launch of K6 and none of K1, reruns bitwise equal, within the
    reference's limit of the plain version (bf16: one ulp of each value,
    half an ulp at the top of the range)."""
    before = dict(K.LAUNCHES)
    a = ca.clip_accum(g, bound)
    assert K.LAUNCHES["clip_accum"] == before["clip_accum"] + 1
    assert K.LAUNCHES["fold_norms"] == before["fold_norms"]
    assert torch.equal(a, ca.clip_accum(g, bound))
    want = ref.clip_accum_plain(g, bound).float()
    tol = dict(atol=1e-5, rtol=1e-5) if g.dtype == torch.float32 else \
        dict(atol=float(want.abs().max()) * 2.0 ** -8, rtol=1e-2)
    torch.testing.assert_close(a.float(), want, **tol)
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extra", [0, 1, 16])
def test_clip_accum_resident_boundary(cuda, dtype, extra):
    """L = 8 at the widest D whose tiles all stay in shared memory
    (extra = 0), one element past it (the element-load path, one tile read
    twice) and a 16-byte vector past it."""
    L, esize = 8, dtype.itemsize
    full = ca.plan(L, 1, esize, _n_sm())["tile"]
    p = ca.plan(L, 1 << 24, esize, _n_sm())
    D = p["grid"] * p["resident"] * full + extra
    q = ca.plan(L, D, esize, _n_sm())
    assert (q["tiles"] - 1) // q["grid"] + 1 == p["resident"] + (extra > 0)
    g = (3 * torch.randn((L, D), generator=cuda, device="cuda")).to(dtype)
    _clip_check(g)


@pytest.mark.parametrize("L,D", [(1, 40000), (1, 7), (12288, 64),
                                 (3000, 1001), (20, 300000)])
def test_clip_accum_clients_and_widths(cuda, L, D):
    """One client; many clients at small D (the coefficients alone in
    shared memory, one block); more rows than a step holds."""
    g = 3 * torch.randn((L, D), generator=cuda, device="cuda")
    _clip_check(g)
    _clip_check(g, 100.0)


def test_clip_accum_unaligned_rows(cuda):
    base = torch.randn((8 * 4097 + 1,), generator=cuda, device="cuda")
    g = base[1:].view(8, 4097)
    assert g.data_ptr() % 16
    _clip_check(g)


def test_clip_accum_graph_replay(cuda):
    """clip_accum captured in a CUDA graph at a shape with several blocks
    and non-resident tiles; each replay finds new gradients and must give
    the eager result, which it can only if the barrier's counter was left
    at zero by the replay before."""
    L, D = 8, 1 << 21
    assert ca.plan(L, D, 4, _n_sm())["grid"] > 1
    g = 3 * torch.randn((L, D), generator=cuda, device="cuda")
    ca.clip_accum(g, 0.5)                               # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ca.clip_accum(g, 0.5)
    for _ in range(3):
        g.copy_(3 * torch.randn((L, D), generator=cuda, device="cuda"))
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ca.clip_accum(g, 0.5))
        torch.testing.assert_close(out, ref.clip_accum_plain(g, 0.5),
                                   atol=1e-5, rtol=1e-5)


def test_captured_workspace_freed_with_its_graph(cuda):
    """Each captured launch of K6 and of K1's split layout takes its
    workspace from the graph's pool: capturing them again and again, each
    graph replayed and then freed, leaves no memory allocated behind."""
    L, D = 8, 1 << 21
    assert rf.norms_plan(2 * L, D, 4, _n_sm())["splits"] > 1
    g = 3 * torch.randn((L, D), generator=cuda, device="cuda")
    h = torch.randn((2, L, D), generator=cuda, device="cuda")
    want_c, want_n = ca.clip_accum(g, 0.5), rf.fold_norms(h)   # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for _ in range(3):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out_c, out_n = ca.clip_accum(g, 0.5), rf.fold_norms(h)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_c, want_c) and torch.equal(out_n, want_n)
        del graph, out_c, out_n
    assert torch.cuda.memory_allocated() == base


def test_two_streams_share_no_tickets(cuda):
    """K6 and K1's split layout on two streams at once, at the same shapes
    on both: each stream's launches use their own workspace, so every
    result matches its plain version."""
    L, D = 8, 1 << 20
    assert rf.norms_plan(2 * L, D, 4, _n_sm())["splits"] > 1
    gs = [3 * torch.randn((L, D), generator=cuda, device="cuda")
          for _ in range(2)]
    hs = [torch.randn((2, L, D), generator=cuda, device="cuda")
          for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [[], []]
    torch.cuda.synchronize()
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append((ca.clip_accum(gs[i], 0.5),
                                rf.fold_norms(hs[i])))
    torch.cuda.synchronize()
    for i in range(2):
        want_c = ref.clip_accum_plain(gs[i], 0.5)
        want_n = rf.fold_norms_plain(hs[i])
        for c, n in outs[i]:
            torch.testing.assert_close(c, want_c, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(n, want_n, atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,D", [(16, 8192), (10, 1000), (1, 4096), (3, 5)])
def test_laplace_transform_matches_plain(cuda, dtype, P, D):
    u = (torch.rand((P, D), generator=cuda, device="cuda") * 0.998
         - 0.499).to(dtype)
    u.view(-1)[0] = 0.0                      # sign(0) = 0
    for sigma in (0.1, 1.0):
        before = K.LAUNCHES["laplace_transform"]
        a = ops.laplace_transform(u, sigma)
        assert K.LAUNCHES["laplace_transform"] == before + 1
        assert float(a.view(-1)[0]) == 0.0
        assert torch.equal(a, lp.laplace_transform(u, sigma))
        torch.testing.assert_close(
            a.float(), ref.laplace_transform_plain(u, sigma).float(),
            **_single_tol(dtype, dict(atol=1e-6, rtol=0)))


def test_laplace_transform_unaligned(cuda):
    # an offset view: the 16-byte vector path is off, the scalar path runs
    base = torch.rand((1, 4097), generator=cuda, device="cuda") - 0.5
    u = base[:, 1:]
    assert u.data_ptr() % 16
    torch.testing.assert_close(lp.laplace_transform(u, 1.0),
                               ref.laplace_transform_plain(u, 1.0),
                               atol=1e-6, rtol=0)


def test_kernel_bench_runs_on_the_card(cuda):
    from repro_torch.launch import kernel_bench as kb
    K.reset_launches()
    micro = dict(kb.micro_rows(reduced=True, device="cuda"))
    rows, _ = kb.round_rows(reduced=True, device="cuda")
    for name in ("secure_agg_mean", "clip_accum", "laplace_transform",
                 "graph_combine", "fold_norms", "fold_apply"):
        assert K.LAUNCHES[name] > 0, name
    assert all(v > 0 for v in micro.values())
    assert all(v == v for _, v in rows)
