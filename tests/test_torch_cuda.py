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
    (4, 32, 8, 1064, 128),    # mixtral: Dh 128, G 4
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
    (4, 32, 8, 4096, 128),    # mixtral's serving shape: Dh 128, G 4
    (2, 8, 8, 1064, 64),      # zamba2's shared block: Dh 64, G 1
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "minicpm3-4b"])
def test_reduced_moe_and_mla_on_cuda_match_the_cpu(cuda, arch):
    """One init on the CPU and its copy on the card: forward logits and
    router aux, prefill and four decode steps within f32's 1e-4; K8 runs a
    layer a step for mixtral and never for the MLA models."""
    import copy
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced()
    on_cpu = Model.init(cfg, rng(1, "cpu"))
    on_card = copy.deepcopy(on_cpu).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(2))
    tol = dict(atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        want = on_cpu.forward(toks)
        got = on_card.forward(toks.cuda())
    torch.testing.assert_close(got.cpu(), want, **tol)
    torch.testing.assert_close(on_card.last_aux.cpu(), on_cpu.last_aux,
                               **tol)
    want, c_cpu = on_cpu.prefill(toks[:, :96])
    got, c_card = on_card.prefill(toks[:, :96].cuda())
    torch.testing.assert_close(got.cpu(), want, **tol)
    K.reset_launches()
    for t in range(4):
        want, c_cpu = on_cpu.decode_step(toks[:, 96 + t], c_cpu)
        got, c_card = on_card.decode_step(toks[:, 96 + t].cuda(), c_card)
        torch.testing.assert_close(got.cpu(), want, **tol)
    for name in c_cpu:
        torch.testing.assert_close(c_card[name].cpu(), c_cpu[name], **tol)
    gqa = cfg.attention == "gqa"
    assert K.LAUNCHES["swa_decode"] == (4 * cfg.num_layers if gqa else 0)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_reduced_ssm_and_hybrid_on_cuda_match_the_cpu(cuda, arch):
    """One init on the CPU and its copy on the card: forward logits,
    prefill with every cache entry and four decode steps within f32's
    1e-4; zamba2's shared block runs K8 (G = 1) once an application and
    step, against its plain version on the CPU; rwkv6 never runs it."""
    import copy
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced()
    on_cpu = Model.init(cfg, rng(1, "cpu"))
    on_card = copy.deepcopy(on_cpu).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(2))
    tol = dict(atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        want = on_cpu.forward(toks)
        got = on_card.forward(toks.cuda())
    torch.testing.assert_close(got.cpu(), want, **tol)
    want, c_cpu = on_cpu.prefill(toks[:, :96])
    got, c_card = on_card.prefill(toks[:, :96].cuda())
    torch.testing.assert_close(got.cpu(), want, **tol)
    for name in c_cpu:
        torch.testing.assert_close(c_card[name].cpu(), c_cpu[name], **tol)
    K.reset_launches()
    for t in range(4):
        want, c_cpu = on_cpu.decode_step(toks[:, 96 + t], c_cpu)
        got, c_card = on_card.decode_step(toks[:, 96 + t].cuda(), c_card)
        torch.testing.assert_close(got.cpu(), want, **tol)
    for name in c_cpu:
        torch.testing.assert_close(c_card[name].cpu(), c_cpu[name], **tol)
    n_attn = (cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else 0)
    assert K.LAUNCHES["swa_decode"] == 4 * n_attn


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_ssm_and_hybrid_decode_step_is_capturable(cuda, arch):
    """One decode step captured in a CUDA graph (it would raise on a host
    sync) and replayed once: logits and every cache entry bitwise the
    eager step's from the same cache."""
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced()
    model = Model.init(cfg, rng(1, "cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=cuda,
                         device="cuda")
    _, cache = model.prefill(toks[:, :40])

    def copy_of(c):
        return {name: t.clone() for name, t in c.items()}

    eager, graphed, warm = copy_of(cache), copy_of(cache), copy_of(cache)
    tok = toks[:, 40].clone()
    want, eager = model.decode_step(tok, eager)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        model.decode_step(tok, warm)                    # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, graphed = model.decode_step(tok, graphed)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert set(graphed) == set(eager)
    for name in eager:
        assert torch.equal(graphed[name], eager[name]), name


def test_moe_decode_layer_is_capturable(cuda):
    """The MoE layer at a decode step's 4 tokens, captured in a CUDA graph
    (it would raise on a host sync) and replayed: bitwise its eager run."""
    from repro_torch import rng
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = moe.moe_init(rng(3, "cuda"), cfg, torch.float32)
    x = torch.randn((4, 1, cfg.d_model), generator=cuda, device="cuda")
    want, want_aux = moe.moe_forward(params, x, cfg)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_forward(params, x, cfg)                 # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, aux = moe.moe_forward(params, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


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


# --------------------------------------------- the round graph (executor)

SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
EVERYTHING = "links:0.2+outage:0.1+straggler:0.3,stale=2+dropout:0.3"


def _round_graph_problem():
    from repro_torch import rng
    from repro_torch.core.simulate import generate_problem
    return generate_problem(rng(0, "cuda"), P=4, K=6, N=20)


def _round_graph_cfg(scheme, use_kernels, iters, **kw):
    from repro_torch.configs.base import GFLConfig
    from repro_torch.core.privacy.accountant import epsilon_at
    return GFLConfig(num_servers=4, clients_per_server=6, clients_sampled=5,
                     topology="ring", privacy=scheme, sigma_g=0.3, mu=0.1,
                     grad_bound=5.0, use_kernels=use_kernels,
                     epsilon_target=epsilon_at(iters, 0.1, 5.0, 0.3),
                     epsilon_horizon=iters, **kw)


def _graph_and_eager(prob, cfg, iters, **kw):
    """(msd, params, launches, replayed) of a run under each executor."""
    from repro_torch.core.simulate import run_gfl
    out = {}
    for executor in ("graph", "eager"):
        K.reset_launches()
        msd, params = run_gfl(prob, cfg, iters=iters, batch_size=5, seed=3,
                              executor=executor, **kw)
        out[executor] = (msd, params, dict(K.LAUNCHES), dict(K.REPLAYED))
    return out


def _assert_bitwise(out):
    (mg, pg, lg, _), (me, pe, le, _) = out["graph"], out["eager"]
    assert torch.equal(pg, pe)
    assert mg.tolist() == me.tolist()
    assert lg == le


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_round_graph_is_the_eager_executor(cuda, scheme, use_kernels):
    """The graph replays every round after the first: params, the MSD
    trace and the launch counts are bitwise the eager executor's, and the
    wrappers launch K1-K3 only in the warm-up round."""
    iters = 7
    out = _graph_and_eager(_round_graph_problem(),
                           _round_graph_cfg(scheme, use_kernels, iters),
                           iters)
    _assert_bitwise(out)
    launches, replayed = out["graph"][2], out["graph"][3]
    for name in ("fold_norms", "fold_apply", "graph_combine"):
        if launches[name]:
            assert launches[name] == iters
            assert launches[name] - replayed[name] == 1


@pytest.mark.parametrize("fault,tau,scheme", [
    ("none", 2, "hybrid"), ("none", 3, "iid_dp"), ("none", 2, "scheduled"),
    (EVERYTHING, 1, "none"), (EVERYTHING, 1, "iid_dp"),
    (EVERYTHING, 1, "hybrid"), (EVERYTHING, 1, "gaussian_dp"),
    (EVERYTHING, 1, "scheduled"), (EVERYTHING, 2, "hybrid"),
    ("links:0.0+dropout:0.0", 1, "hybrid")])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_round_graph_combine_every_and_faults(cuda, fault, tau, scheme,
                                              use_kernels):
    """combine_every > 1 (a graph that combines and one that does not) and
    faulted runs (A_i, masks staged, straggler state in the graph)."""
    iters = 9
    cfg = _round_graph_cfg(scheme, use_kernels, iters, fault=fault,
                           combine_every=tau, topology_seed=7)
    _assert_bitwise(_graph_and_eager(_round_graph_problem(), cfg, iters,
                                     record_every=2))


def test_round_graph_scan(cuda):
    from repro_torch.core.population.engine import run_gfl_population
    prob = _round_graph_problem()
    cfg = _round_graph_cfg("hybrid", True, 6)
    runs = [run_gfl_population(prob, cfg, iters=6, batch_size=5, seed=4,
                               record_every=2, scan=True, executor=ex)
            for ex in ("graph", "eager")]
    assert torch.equal(runs[0].params, runs[1].params)
    assert runs[0].msd.tolist() == runs[1].msd.tolist()


def test_round_graph_memory_is_flat(cuda):
    """Twenty runs, each capturing its round graph and freeing it at the
    end, leave the allocated memory where the first left it."""
    from repro_torch.core.simulate import run_gfl
    prob = _round_graph_problem()
    cfg = _round_graph_cfg("hybrid", True, 4)
    run_gfl(prob, cfg, iters=4, batch_size=5, seed=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for seed in range(20):
        run_gfl(prob, cfg, iters=4, batch_size=5, seed=seed)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


def test_round_graph_memory_is_flat_with_kernels_off(cuda):
    """The same with the kernels off: the combine's torch.matmul makes
    cuBLAS keep a workspace for the stream it runs on, so every run must
    capture on the one stream it captured on before."""
    from repro_torch.core.simulate import run_gfl
    prob = _round_graph_problem()
    cfg = _round_graph_cfg("hybrid", False, 4)
    run_gfl(prob, cfg, iters=4, batch_size=5, seed=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for seed in range(20):
        run_gfl(prob, cfg, iters=4, batch_size=5, seed=seed)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


def test_round_graph_refuses_replayed_draws(cuda):
    import numpy as np
    from repro_torch.core.simulate import run_gfl
    from repro_torch.draws import ReplayDraws
    prob = _round_graph_problem()
    draws = ReplayDraws([[("cohort", "cohort", (np.zeros((4, 5), int),
                                                np.zeros((4, 5, 5), int)))]],
                        device="cuda")
    with pytest.raises(RuntimeError, match="executor='eager'"):
        run_gfl(prob, _round_graph_cfg("none", False, 1), iters=1,
                batch_size=5, draws=draws)


# ------------------------------------------- the population's weighted path

WEIGHTED = {"importance": "importance,floor=0.2",
            "trace": "uniform+trace:diurnal,period=6,min=0.3",
            "both": "importance,floor=0.2+trace:devclass,slow=0.5,p=0.3"}


def _weighted_cfg(scheme, use_kernels, cohort, fault="none", tau=1):
    from repro_torch.configs.base import GFLConfig
    return GFLConfig(num_servers=4, clients_per_server=500,
                     clients_sampled=6, topology="ring", privacy=scheme,
                     sigma_g=0.3, mu=0.1, grad_bound=5.0,
                     use_kernels=use_kernels, cohort=WEIGHTED[cohort],
                     fault=fault, combine_every=tau, topology_seed=7,
                     population="synthetic:mixture,clusters=3",
                     epsilon_target=200.0, epsilon_horizon=9)


def _weighted_runs(cfg, iters=9):
    from repro_torch.core.population import run_gfl_population
    out = {}
    for executor in ("graph", "eager"):
        K.reset_launches()
        res = run_gfl_population(None, cfg, iters=iters, batch_size=5,
                                 seed=3, executor=executor, device="cuda")
        out[executor] = (res, dict(K.LAUNCHES), dict(K.REPLAYED))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cohort,fault,tau", [
    ("importance", "none", 1), ("trace", "links:0.2+dropout:0.3", 1),
    ("both", "dropout:0.3", 2)])
def test_weighted_round_graph_is_the_eager_executor(cuda, scheme,
                                                    use_kernels, cohort,
                                                    fault, tau):
    """The weighted round under the round graph: params, MSD, q, the IS
    state, the gaps and the launch counts bitwise the eager executor's;
    the wrappers launch K1-K3 only in each graph's warm-up round."""
    import numpy as np
    out = _weighted_runs(_weighted_cfg(scheme, use_kernels, cohort, fault,
                                       tau))
    (rg, lg, replayed), (re, le, _) = out["graph"], out["eager"]
    assert torch.equal(rg.params, re.params)
    assert rg.msd.tolist() == re.msd.tolist()
    assert rg.q.tolist() == re.q.tolist()
    assert ((rg.q > 0) & (rg.q <= 1)).all()
    if rg.scheduler.is_state is not None:
        for a, b in zip(rg.scheduler.is_state, re.scheduler.is_state):
            assert torch.equal(a, b)
    assert (rg.gaps is None) == (re.gaps is None)
    if rg.gaps is not None:
        assert np.array_equal(rg.gaps, re.gaps)
    assert lg == le
    for name in ("fold_norms", "fold_apply", "graph_combine"):
        if lg[name]:
            assert lg[name] - replayed[name] <= tau


def test_duplicate_index_update_is_deterministic(cuda):
    """Clients repeat within rows (K = 3, L = 64): the last slot wins, the
    same on every run and as on the CPU."""
    from repro_torch.core import sampling as IS
    idx = torch.randint(0, 3, (8, 64), generator=cuda, device="cuda")
    norms = 10 * torch.rand((8, 64), generator=cuda, device="cuda")
    runs = [IS.update_norm_estimates(IS.init_is_state(8, 3, "cuda"), idx,
                                     norms) for _ in range(2)]
    assert torch.equal(runs[0].norm_est, runs[1].norm_est)
    assert torch.equal(runs[0].counts, runs[1].counts)
    cpu = IS.update_norm_estimates(IS.init_is_state(8, 3), idx.cpu(),
                                   norms.cpu())
    torch.testing.assert_close(runs[0].norm_est.cpu(), cpu.norm_est,
                               atol=1e-6, rtol=0)
    assert torch.equal(runs[0].counts.cpu(), cpu.counts)
    last = idx[:, -1]
    want = 0.7 + 0.3 * norms[:, -1]
    assert torch.equal(runs[0].norm_est.gather(1, last[:, None])[:, 0],
                       want)


def test_weighted_draw_at_1e5_clients_with_a_mask(cuda):
    """K = 10^5, P = 8, L = 20, half the clients unavailable: every pick
    available, the same picks as the CPU's inverse CDF on the same
    uniforms and probabilities (f64 on both)."""
    from repro_torch.core import sampling as IS
    P, Kn, L = 8, 100_000, 20
    est = 5 * torch.rand((P, Kn), generator=cuda, device="cuda")
    avail = torch.rand((P, Kn), generator=cuda, device="cuda") < 0.5
    probs = IS.sampling_probs(IS.ISState(est, est.int())) * avail
    probs = probs / probs.sum(dim=1, keepdim=True)
    u = torch.rand((P, L), generator=cuda, device="cuda")
    idx = IS.sample_clients(probs, u)
    assert avail.gather(1, idx).all()
    assert torch.equal(idx.cpu(), IS.sample_clients(probs.cpu(), u.cpu()))


def test_weighted_round_graph_memory_is_flat(cuda):
    from repro_torch.core.population import run_gfl_population
    cfg = _weighted_cfg("hybrid", True, "both", "links:0.2+dropout:0.3")
    run_gfl_population(None, cfg, iters=4, batch_size=5, seed=1,
                       device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for seed in range(20):
        run_gfl_population(None, cfg, iters=4, batch_size=5, seed=seed,
                           device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


def test_synthetic_population_hash_bits_match_the_cpu(cuda):
    """The gather's labels (hash bits) are the CPU's exactly; its features
    (Box-Muller in float64, one cast) within 1e-6."""
    from repro_torch.core.population import SyntheticPopulation
    idx = torch.randint(0, 10 ** 9, (8, 20), generator=cuda, device="cuda")
    bidx = torch.randint(0, 100, (8, 20, 10), generator=cuda, device="cuda")
    for mode in ("iid", "hetero", "mixture"):
        gpu = SyntheticPopulation(8, 10 ** 9, mode=mode, device="cuda")
        cpu = SyntheticPopulation(8, 10 ** 9, mode=mode, device="cpu")
        hg, gg = gpu.gather(idx, bidx)
        hc, gc_ = cpu.gather(idx.cpu(), bidx.cpu())
        assert torch.equal(gg.cpu(), gc_)
        torch.testing.assert_close(hg.cpu(), hc, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fault", ["none", "links:0.2+dropout:0.3"])
def test_weighted_round_graph_over_a_dirichlet_population(cuda, fault):
    from dataclasses import replace
    cfg = replace(_weighted_cfg("hybrid", True, "both", fault),
                  clients_per_server=60, population="dirichlet:0.3,pool=4000")
    out = _weighted_runs(cfg, iters=7)
    (rg, lg, _), (re, le, _) = out["graph"], out["eager"]
    assert torch.equal(rg.params, re.params)
    assert rg.msd.tolist() == re.msd.tolist() and lg == le
    assert lg["fold_apply"] == 7


# --------------------------------------------------------- the event engine

EVENTS = {"diurnal": ("uniform+trace:diurnal,period=6,min=0.3",
                      "async:buffer=8,latency=lognorm:0.7,max_stale=3,"
                      "rate=6", "none"),
          "importance": ("importance,floor=0.2+trace:devclass,slow=0.5,"
                         "p=0.3", "async:buffer=10,latency=exp:1.0,"
                                  "max_stale=2,rate=8", "links:0.3")}


def _event_cfg(scheme, use_kernels, case):
    from repro_torch.configs.base import GFLConfig
    cohort, spec, fault = EVENTS[case]
    return GFLConfig(num_servers=4, clients_per_server=500, topology="ring",
                     privacy=scheme, sigma_g=0.3, mu=0.1, grad_bound=5.0,
                     use_kernels=use_kernels, cohort=cohort, async_spec=spec,
                     fault=fault, topology_seed=7,
                     population="synthetic:mixture,clusters=3",
                     epsilon_target=200.0, epsilon_horizon=9)


def _event_runs(cfg, ticks=9, **kw):
    from repro_torch.core.events import run_gfl_async
    out = {}
    for executor in ("graph", "eager"):
        K.reset_launches()
        res = run_gfl_async(None, cfg, ticks=ticks, batch_size=5, seed=3,
                            executor=executor, device="cuda", **kw)
        out[executor] = (res, dict(K.LAUNCHES), dict(K.REPLAYED))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("case", list(EVENTS))
def test_event_tick_graph_is_the_eager_executor(cuda, scheme, use_kernels,
                                                case):
    """The event tick under the round graph: params, MSD, the flush, q,
    staleness, event and drop schedules and the launch counts bitwise the
    eager executor's; the wrappers launch K1-K3 only in the warm-up tick;
    ``scan=True`` is bitwise the loop."""
    import numpy as np
    cfg = _event_cfg(scheme, use_kernels, case)
    out = _event_runs(cfg)
    (rg, lg, replayed), (re, le, _) = out["graph"], out["eager"]
    assert torch.equal(rg.params, re.params)
    assert rg.msd.tolist() == re.msd.tolist()
    for field in ("flushed", "q", "staleness", "events", "dropped_stale"):
        assert np.array_equal(getattr(rg, field), getattr(re, field))
    assert lg == le
    for name in ("fold_norms", "fold_apply", "graph_combine"):
        if lg[name]:
            assert lg[name] == 9 and lg[name] - replayed[name] == 1
    scan = _event_runs(cfg, scan=True)["graph"][0]
    assert torch.equal(scan.params, rg.params)
    assert scan.msd.tolist() == rg.msd.tolist()
    assert np.array_equal(scan.flushed, rg.flushed)


def test_event_sync_limit_is_run_gfl_population_on_the_card(cuda):
    from repro_torch.core.events import run_gfl_async
    from repro_torch.core.population import run_gfl_population
    prob = _round_graph_problem()
    cfg = _round_graph_cfg("hybrid", True, 6, async_spec="async:buffer=5")
    a = run_gfl_async(prob, cfg, ticks=6, batch_size=5, seed=3)
    p = run_gfl_population(prob, cfg, iters=6, batch_size=5, seed=3)
    assert torch.equal(a.params, p.params) and a.msd.tolist() == p.msd.tolist()


def test_event_tick_graph_memory_is_flat(cuda):
    """Twenty runs of ``run_gfl_async``, each capturing its tick graph and
    freeing it, leave the allocated memory where the first left it."""
    from repro_torch.core.events import run_gfl_async
    cfg = _event_cfg("hybrid", True, "importance")
    run_gfl_async(None, cfg, ticks=4, batch_size=5, seed=1, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for seed in range(20):
        run_gfl_async(None, cfg, ticks=4, batch_size=5, seed=seed,
                      device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


# ------------------------------------------- telemetry under the round graph


def _observed(fn):
    """(result, records by stream) of ``fn()`` under a memory session."""
    from repro_torch.telemetry import session
    with session("memory", trace_path="") as sess:
        out = fn()
    by = {}
    for r in sess.memory_records():
        by.setdefault(r["stream"], []).append(r)
    return out, by


@pytest.mark.parametrize("engine", ["loop", "scan", "weighted", "events",
                                    "events_scan"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_round_graph_telemetry_on_is_off(cuda, engine, use_kernels):
    """Telemetry on under the round graph (the taps captured into it):
    params and traces bitwise the run with telemetry off, and the step
    and round streams complete."""
    import dataclasses
    from repro_torch.core.events import run_gfl_async
    from repro_torch.core.population import run_gfl_population
    if engine in ("loop", "scan"):
        prob, cfg = _round_graph_problem(), _round_graph_cfg(
            "hybrid", use_kernels, 6)

        def run(c):
            return run_gfl_population(prob, c, iters=6, batch_size=5,
                                      seed=3, scan=engine == "scan")
    elif engine == "weighted":
        cfg = _weighted_cfg("hybrid", use_kernels, "importance")

        def run(c):
            return run_gfl_population(None, c, iters=6, batch_size=5,
                                      seed=3, device="cuda")
    else:
        cfg = _event_cfg("hybrid", use_kernels, "importance")

        def run(c):
            return run_gfl_async(None, c, ticks=6, batch_size=5, seed=3,
                                 device="cuda", scan=engine == "events_scan")
    off = run(cfg)
    on, recs = _observed(lambda: run(dataclasses.replace(
        cfg, telemetry="memory")))
    assert torch.equal(off.params, on.params)
    assert off.msd.tolist() == on.msd.tolist()
    assert len(recs["round"]) == 6
    if engine in ("loop", "scan", "events_scan"):
        assert len(recs["step"]) == 6
        for r in recs["step"]:
            assert all(v == v for v in r.values() if isinstance(v, float))
    if engine == "weighted":
        assert all(r["grad_norm_max"] >= r["grad_norm_mean"] > 0
                   for r in recs["round"])
    if use_kernels:
        assert {r["backend"] for r in recs["kernel"]} == {"cuda"}


def test_emit_raises_under_capture(cuda):
    """A captured round may not sync with the host."""
    from repro_torch.telemetry import emit, session
    x = torch.ones(4, device="cuda")
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with session("memory", trace_path=""):
        with pytest.raises(RuntimeError, match="capturing"):
            with torch.cuda.graph(graph, stream=stream):
                y = x * 2
                emit("step", {"step": 1, "msd": y.sum()})
    torch.cuda.synchronize()


def test_second_run_of_a_shape_reads_no_retrace(cuda):
    """Every run captures its round graph and frees it (compile_s grows
    with each), but only the first capture of a shape is a retrace: a
    second run of that shape reads 0, and is bitwise the eager run of its
    seed.  Its replays launch the kernels every round but the warm-up."""
    import dataclasses
    from repro_torch.core.simulate import run_gfl
    from repro_torch.telemetry import profile
    prob = _round_graph_problem()
    cfg = dataclasses.replace(_round_graph_cfg("hybrid", True, 5), mu=0.137)
    before = profile.compile_counters()
    run_gfl(prob, cfg, iters=5, batch_size=5, seed=1)
    mid = profile.compile_counters()
    K.reset_launches()
    second = run_gfl(prob, cfg, iters=5, batch_size=5, seed=2)
    after = profile.compile_counters()
    assert mid["retraces"] - before["retraces"] == 1
    assert after["retraces"] == mid["retraces"]
    assert after["compile_s"] > mid["compile_s"]
    assert K.LAUNCHES["fold_apply"] == 5 and K.REPLAYED["fold_apply"] == 4
    eager = run_gfl(prob, cfg, iters=5, batch_size=5, seed=2,
                    executor="eager")
    assert torch.equal(second[1], eager[1])
    assert second[0].tolist() == eager[0].tolist()


def test_checkpoint_round_trips_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    tree = {"p": torch.randn(3, 4, device="cuda", generator=cuda),
            "b": torch.randn(5, device="cuda", generator=cuda).bfloat16()}
    save_checkpoint(str(tmp_path / "ck"), tree)
    got, _ = load_checkpoint(str(tmp_path / "ck"),
                             {k: torch.zeros_like(v) for k, v in tree.items()})
    for k, v in tree.items():
        assert got[k].device == v.device and got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.int16) if v.dtype ==
                           torch.bfloat16 else got[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16
                           else v)


# ------------------------------------------------------------------ fleet


FLEET_PROBLEM = dict(P=4, K=16, n=12, buffer=6, events=4, sigma_g=0.2,
                     seed=3)


def test_fleet_inproc_on_the_card_is_the_cpu_fleet(cuda, tmp_path):
    """The demo's problem on inproc, cuda against the CPU: integer outcomes
    exact, params within atol 1e-5, MSD within rtol 1e-5; K1 + K2 once a
    worker tick, K3 once a flushing tick."""
    import numpy as np
    from repro_torch.core.fleet import FleetProblem, run_fleet
    prob = FleetProblem(**FLEET_PROBLEM)
    ticks = 10
    K.reset_launches()
    on = run_fleet(prob, "fleet", ticks, ckpt_root=str(tmp_path / "cuda"),
                   device="cuda")
    launches = dict(K.LAUNCHES)
    off = run_fleet(prob, "fleet", ticks, ckpt_root=str(tmp_path / "cpu"),
                    device="cpu")
    assert on.params.device.type == "cuda"
    assert np.array_equal(on.flushed, off.flushed)
    assert np.array_equal(on.q, off.q)
    assert np.array_equal(on.versions, off.versions)
    assert on.q_ledgers == off.q_ledgers
    assert float((on.params.cpu() - off.params).abs().max()) <= 1e-5
    assert np.allclose(on.msd, off.msd, rtol=1e-5, atol=0)
    assert launches["fold_norms"] == launches["fold_apply"] == \
        prob.P * ticks
    assert launches["graph_combine"] == int(on.flushed.any(axis=1).sum())


def test_fleet_workers_on_two_streams_at_once(cuda, tmp_path):
    """Two inproc workers fold at once, each on its own stream: their
    replies equal those of one worker run alone, bit for bit."""
    import threading

    import numpy as np
    from repro_torch.core.fleet import (FleetProblem, FleetWorker, InprocHub,
                                        parse_fleet_spec)
    from repro_torch.core.fleet.coordinator import fleet_cohort
    prob = FleetProblem(**dict(FLEET_PROBLEM, dim=2048))
    spec = parse_fleet_spec("fleet")
    rng = np.random.default_rng(1)
    ws = [rng.normal(size=prob.dim).astype(np.float32) for _ in range(12)]

    def drive(worker, out):
        with worker.on_stream():
            for t, w in enumerate(ws):
                cohort = [int(k) for k in fleet_cohort(prob, t)[worker.p]]
                out.append(worker.compute_tick(t, w, cohort))

    def fresh(p, tag):
        return FleetWorker(p, prob, spec, InprocHub().register(tag),
                           str(tmp_path / tag), device="cuda")

    alone = {p: [] for p in (0, 1)}
    for p in (0, 1):
        drive(fresh(p, f"alone{p}"), alone[p])
    together = {p: [] for p in (0, 1)}
    workers = [fresh(p, f"together{p}") for p in (0, 1)]
    assert workers[0].stream != workers[1].stream
    threads = [threading.Thread(target=drive, args=(w, together[w.p]))
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert together == alone
    assert any(r["flushed"] for r in alone[0])
