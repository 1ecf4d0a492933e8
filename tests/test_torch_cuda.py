"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one (as on a CPU-only machine).  This file imports
neither jax nor the reference, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: f32 atol 1e-5 (the reference's parity contract), squared norms
rtol 1e-5, hash streams exactly equal; every kernel repeats bit for bit.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import graph_combine as gc
from repro_torch.kernels import round_fold as rf
from repro_torch.kernels import secure_agg as sa

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
@pytest.mark.parametrize("P,D", [(10, 2), (7, 509)])
def test_graph_combine_matches_plain(cuda, variant, P, D):
    a_t = torch.rand((P, P), generator=cuda, device="cuda")
    psi = torch.randn((P, D), generator=cuda, device="cuda")
    g = None if variant == "none" else torch.randn((P, D), generator=cuda,
                                                   device="cuda")
    cache = gate = None
    if variant == "gate":
        cache = torch.randn((P, D), generator=cuda, device="cuda")
        gate = (torch.arange(P, device="cuda") % 2).float()
    a = gc.graph_combine(a_t, psi, g, cache=cache, gate=gate)
    assert torch.equal(a, gc.graph_combine(a_t, psi, g, cache=cache,
                                           gate=gate))
    torch.testing.assert_close(
        a, gc.graph_combine_plain(a_t, psi, g, cache=cache, gate=gate),
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
