"""RWKV-6 (Finch) and the ssm family on the CPU, held against the JAX
reference: the inits' shapes and dtypes (``w0`` and ``u`` f32), token
shift, the data-dependent mixing and decay, ``_group_norm`` (the
population variance), time mixing with a carried state and ``prev_x``,
channel mixing, reduced rwkv6-3b whole (forward, prefill with every cache
entry, 8 greedy decode steps), ``model_params_from_numpy`` on a bf16
tree, the serve entry, and prefill + decode against the port's own
forward.

Tolerances: the layers and the whole model atol = rtol = 1e-4 (as
tests/test_torch_moe.py), the elementwise pieces atol 1e-6; the port
against itself atol = rtol = 2e-2 (as the reference's own decode-vs-forward
test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import rwkv as ref_rwkv
from repro_torch import rng
from repro_torch.configs import registry as t_registry
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.model import Model
from test_torch_models import _to_port_config
from test_torch_ssm import _bits, _close, whole_model_matches

TOL = dict(atol=1e-4, rtol=1e-4)
FINE = dict(atol=1e-6, rtol=1e-6)


def _cfg():
    return ref_registry.get_config("rwkv6-3b").reduced()


def _params(init, cfg, seed=0):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg,
                                         jnp.float32))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _x(cfg, B, S, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inits_match_reference(dtype):
    cfg = _cfg()
    pcfg = _to_port_config(cfg)
    for ref_init, t_init in ((ref_rwkv.rwkv6_att_init, t_rwkv.rwkv6_att_init),
                             (ref_rwkv.rwkv6_ffn_init,
                              t_rwkv.rwkv6_ffn_init)):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            ref_init(jax.random.PRNGKey(0), cfg,
                                     jnp.dtype(dtype)))
        got = t_init(torch.Generator().manual_seed(0), pcfg,
                     getattr(torch, dtype))
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == want
    att = t_rwkv.rwkv6_att_init(torch.Generator().manual_seed(0), pcfg,
                                getattr(torch, dtype))
    assert att["w0"].dtype == att["u"].dtype == torch.float32
    assert torch.equal(att["w0"], torch.full((cfg.d_model,), -6.0))
    assert torch.equal(att["mu"].float(), torch.full((5, cfg.d_model), 0.5))


def test_mix_inputs_and_decay_match():
    cfg = _cfg()
    p = _params(ref_rwkv.rwkv6_att_init, cfg)
    x, prev = _x(cfg, 2, 9, 1), _x(cfg, 2, 1, 2)[:, 0]
    sx_want = ref_rwkv._token_shift(jnp.asarray(x), jnp.asarray(prev))
    sx = t_rwkv._token_shift(torch.tensor(x), torch.tensor(prev))
    _close(sx, sx_want, "token shift", dict(atol=0, rtol=0))
    want = ref_rwkv._mix_inputs(_j(p), jnp.asarray(x), sx_want)
    got = t_rwkv._mix_inputs(_t(p), torch.tensor(x), sx)
    for name, g, w in zip("wkvrg", got, want):
        _close(g, w, f"x{name}", FINE)
    _close(t_rwkv._decay(_t(p), got[0]), ref_rwkv._decay(_j(p), want[0]),
           "decay", FINE)


def test_group_norm_is_the_population_variance():
    """4 channels a head: the unbiased variance would be 4/3 of the
    population one, far outside the tolerance."""
    y = np.array([[[[1.0, 2.0, 4.0, 7.0], [0.5, -0.5, 3.0, 1.0]]]],
                 np.float32)                                 # [1,1,2,4]
    scale = np.linspace(0.5, 2.0, 8).astype(np.float32)
    want = ref_rwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), 2)
    got = t_rwkv._group_norm(torch.tensor(y), torch.tensor(scale), 2)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1, 8)
    _close(got, want, "group norm", FINE)
    yt = torch.tensor(y)
    unbiased = ((yt - yt.mean(-1, keepdim=True))
                * torch.rsqrt(yt.var(-1, keepdim=True) + 1e-5)
                ).reshape(1, 1, 8) * torch.tensor(scale)
    assert float((unbiased - torch.tensor(np.asarray(want))).abs().max()) \
        > 0.1


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("S", [1, 7, 33])
def test_time_mixing_matches(S, carry):
    cfg = _cfg()
    p = _params(ref_rwkv.rwkv6_att_init, cfg)
    H, hs = ref_rwkv.rwkv_dims(cfg)
    x = _x(cfg, 2, S, S)
    st = prev = None
    if carry:
        st = (0.5 * np.random.default_rng(3).standard_normal(
            (2, H, hs, hs))).astype(np.float32)
        prev = _x(cfg, 2, 1, 4)[:, 0]
    want, (wst, wlast) = ref_rwkv.rwkv6_att_forward(
        _j(p), jnp.asarray(x), cfg,
        state=None if st is None else jnp.asarray(st),
        prev_x=None if prev is None else jnp.asarray(prev))
    st_t = None if st is None else torch.tensor(st)
    got, (gst, glast) = t_rwkv.rwkv6_att_forward(
        _t(p), torch.tensor(x), _to_port_config(cfg), state=st_t,
        prev_x=None if prev is None else torch.tensor(prev))
    _close(got, want, "time mixing out", TOL)
    _close(gst, wst, "wkv state", TOL)
    _close(glast, wlast, "last x", dict(atol=0, rtol=0))
    if carry:                       # the state passed in is not written
        assert np.array_equal(st_t.numpy(), st)


@pytest.mark.parametrize("carry", [False, True])
def test_channel_mixing_matches(carry):
    cfg = _cfg()
    p = _params(ref_rwkv.rwkv6_ffn_init, cfg)
    x = _x(cfg, 2, 11, 5)
    prev = _x(cfg, 2, 1, 6)[:, 0] if carry else None
    want, wlast = ref_rwkv.rwkv6_ffn_forward(
        _j(p), jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    got, glast = t_rwkv.rwkv6_ffn_forward(
        _t(p), torch.tensor(x), None if prev is None else torch.tensor(prev))
    _close(got, want, "channel mixing", TOL)
    _close(glast, wlast, "last x", dict(atol=0, rtol=0))


def test_init_cache_matches_reference():
    cfg = _cfg()
    want = ref_rwkv.rwkv6_init_cache(cfg, 3, 2, jnp.float32)
    got = t_rwkv.rwkv6_init_cache(_to_port_config(cfg), 3, 2, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("S", [37, 64])
def test_whole_rwkv6_matches_reference(S):
    port = whole_model_matches(_cfg(), S)
    assert port.shared_attn is None
    assert all(set(bp) == {"ln1", "att", "ln2", "ffn"} for bp in port.blocks)


def test_convert_carries_a_bf16_tree():
    cfg = dataclasses.replace(_cfg(), param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RefModel(cfg).init(jax.random.PRNGKey(2)))
    pcfg = _to_port_config(cfg)
    params = model_params_from_numpy(tree, pcfg, "cpu")
    assert set(params) == {"embed", "final_norm", "lm_head", "blocks"}
    for i, bp in enumerate(params["blocks"]):
        for part in ("att", "ffn"):
            for leaf, t in bp[part].items():
                want = tree["blocks"][part][leaf][i]
                f32 = (part, leaf) in (("att", "w0"), ("att", "u"))
                assert t.dtype == (torch.float32 if f32 else torch.bfloat16)
                got = t.numpy() if f32 else \
                    t.view(torch.int16).numpy().view(np.uint16)
                assert np.array_equal(got, _bits(want)), (part, leaf)
    model = Model(pcfg, params)
    assert {n for n, p in model.named_parameters()
            if p.dtype == torch.float32} == {
        f"blocks.{i}.att.{leaf}" for i in range(cfg.num_layers)
        for leaf in ("w0", "u")}
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["att"]["u"] = tree["blocks"]["att"]["u"].astype(
        jnp.bfloat16)
    with pytest.raises(TypeError, match="att.u"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["att"]["maa_w2"] = tree["blocks"]["att"]["maa_w2"][:, :, 1:]
    with pytest.raises(ValueError, match="maa_w2"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["att"]["gate_lora"] = tree["blocks"]["att"]["u"]
    with pytest.raises(ValueError, match="leaves"):
        model_params_from_numpy(bad, pcfg, "cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_decode_matches_forward(arch):
    """prefill + 4 decode steps == the full forward (teacher forcing) on
    the port alone."""
    cfg = t_registry.get_config(arch).reduced()
    gen = rng(1, "cpu")
    model = Model.init(cfg, gen)
    S = 24
    toks = torch.randint(0, cfg.vocab_size, (2, S + 4), generator=gen)
    with torch.no_grad():
        full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :S])
    torch.testing.assert_close(logits, full[:, S - 1], atol=2e-2, rtol=2e-2)
    for t in range(4):
        logits, cache = model.decode_step(toks[:, S + t], cache)
        torch.testing.assert_close(logits, full[:, S + t], atol=2e-2,
                                   rtol=2e-2)


def test_serve_main_on_the_cpu(capsys):
    out = serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40",
                      "--new-tokens", "4", "--seed", "0"])
    assert out["tokens"].shape == (2, 5)
    assert torch.isfinite(out["logits"]).all()
    assert set(out["cache"]) == {"wkv", "att_x", "ffn_x", "pos"}
    text = capsys.readouterr().out
    assert "prefill 2x40" in text and "tok/s" in text
