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
atol = rtol = 3e-2 in bf16.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import clip_accum as ca
from repro_torch.kernels import graph_combine as gc
from repro_torch.kernels import laplace as lp
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import round_fold as rf
from repro_torch.kernels import secure_agg as sa
from repro_torch.kernels import swa_decode as swa

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
        # pass 1 runs K1's kernel under clip_accum's count alone
        assert K.LAUNCHES["clip_accum"] == before["clip_accum"] + 1
        assert K.LAUNCHES["fold_norms"] == before["fold_norms"]
        assert torch.equal(a, ca.clip_accum(g, bound))
        torch.testing.assert_close(
            a.float(), ref.clip_accum_plain(g, bound).float(),
            **_single_tol(dtype, dict(atol=1e-5, rtol=1e-5)))


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
