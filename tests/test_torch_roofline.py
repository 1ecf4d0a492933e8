"""The port's roofline module against ``repro.launch.roofline``: the
analytic round traffic and the model-FLOP counts are exactly equal; the
card's roofs are the data sheet's, with the INT32 rate derived."""
import pytest

from repro.configs import base as ref_base
from repro.configs.registry import get_config as ref_get_config
from repro.launch import roofline as ref_rl
from repro_torch.configs import base as t_base
from repro_torch.configs.registry import get_config
from repro_torch.launch import roofline as rl


@pytest.mark.parametrize("mode", ["none", "mask", "laplace"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("P,L,D", [(10, 8, 16384), (16, 8, 8192),
                                   (3, 13, 509)])
def test_round_pipeline_traffic_equals_reference(mode, fused, P, L, D):
    for itemsize in (4, 2):
        assert rl.round_pipeline_traffic(P, L, D, itemsize=itemsize,
                                         mode=mode, fused=fused) == \
            ref_rl.round_pipeline_traffic(P, L, D, itemsize=itemsize,
                                          mode=mode, fused=fused)


def _moe_pair():
    kw = dict(name="moe-test", family="moe", num_layers=6, d_model=256,
              num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1000)
    moe = dict(num_experts=8, num_shared_experts=1, top_k=2,
               expert_d_ff=128, first_dense_layers=2)
    return (t_base.ModelConfig(moe=t_base.MoEConfig(**moe), **kw),
            ref_base.ModelConfig(moe=ref_base.MoEConfig(**moe), **kw))


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_model_flops_and_active_params_equal_reference(which):
    if which == "dense":
        cfg, ref_cfg = get_config("phi3-mini-3.8b"), \
            ref_get_config("phi3-mini-3.8b")
    else:
        cfg, ref_cfg = _moe_pair()
    n = 3_821_079_552
    active = rl.active_params(cfg, n)
    assert active == ref_rl.active_params(ref_cfg, n)
    assert (active < n) == (which == "moe")
    for kind in ("train", "serve"):
        assert rl.model_flops_estimate(n, active, 4096, kind) == \
            ref_rl.model_flops_estimate(n, active, 4096, kind)


def test_card_roofs():
    assert rl.HBM_BYTES_PER_S == 3.35e12 and rl.F32_OPS_PER_S == 67e12
    assert rl.L2_BYTES == 50 * 2 ** 20 and rl.SM_COUNT == 132
    # 64 INT32 lanes per SM at the clock the fp32 peak implies
    assert rl.SM_CLOCK_HZ == pytest.approx(1.983e9, rel=1e-3)
    assert rl.INT32_OPS_PER_S == pytest.approx(rl.F32_OPS_PER_S / 4)


@pytest.mark.parametrize("nbytes,flops,int_ops,by", [
    (3.35e9, 0, 0, "bytes"),               # 1 ms of HBM traffic
    (3.35e6, 67e9, 0, "operations"),       # 1 ms of fp32 work
    (3.35e6, 0, 2 * 16.75e9, "operations"),
])
def test_kernel_bound(nbytes, flops, int_ops, by):
    ms, got_by = rl.kernel_bound_ms(nbytes, flops, int_ops)
    assert got_by == by
    want = max(nbytes / 3.35e12, flops / 67e12, int_ops / rl.INT32_OPS_PER_S)
    assert ms == pytest.approx(want * 1e3)


def test_roofline_finalize_picks_the_bottleneck():
    r = rl.Roofline("phi3-mini-3.8b", "decode b4", flops=2 * 3.8e9 * 4,
                    hbm_bytes=7.6e9, model_flops=2 * 3.8e9 * 4).finalize()
    assert r.bottleneck == "memory"
    assert r.memory_s == pytest.approx(7.6e9 / 3.35e12)
    assert r.useful_flop_frac == 1.0
    r = rl.Roofline("x", "prefill", flops=1e15, hbm_bytes=1e9,
                    model_flops=5e14).finalize()
    assert r.bottleneck == "compute" and r.useful_flop_frac == 0.5
    assert '"bottleneck": "compute"' in r.to_json()
