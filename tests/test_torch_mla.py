"""Multi-head latent attention on the CPU, held against the JAX reference:
``mla_init`` shapes, ``_mla_qkr``, the unabsorbed chunked ``mla_forward``
and the absorbed ``mla_decode`` with its cache writes (the clamp at
``pos >= C`` included), with and without query compression (reduced
minicpm3-4b and deepseek-v2-lite-16b), and reduced minicpm3-4b whole.

Tolerances: the MLA layer f32 atol 1e-5 (the same products, sums in
another order); the whole model atol = rtol = 1e-4 (as
tests/test_torch_models.py); the port against itself atol 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro_torch import rng
from repro_torch.configs import registry as t_registry
from repro_torch.models import attention as t_attn
from repro_torch.models.model import Model, check_supported
from test_torch_models import _to_port_config
from test_torch_moe import whole_model_matches

ARCHS = {"q_lora": "minicpm3-4b", "no_q_lora": "deepseek-v2-lite-16b"}
ATOL = 1e-5


def _setup(which, seed=0):
    cfg = ref_registry.get_config(ARCHS[which]).reduced()
    params = jax.tree.map(np.asarray, ref_attn.mla_init(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    assert ("w_dq" in params) == (which == "q_lora")
    return cfg, params


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("which", list(ARCHS))
def test_mla_init_shapes_match_reference(which):
    cfg, params = _setup(which)
    got = t_attn.mla_init(torch.Generator().manual_seed(0),
                          _to_port_config(cfg), torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in params.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert torch.equal(got["kv_norm"], torch.ones(cfg.mla.kv_lora_rank))


@pytest.mark.parametrize("which", list(ARCHS))
def test_mla_qkr_matches(which):
    cfg, params = _setup(which)
    B, S = 2, 20
    x = _x(cfg, B, S, 1)
    pos = np.stack([np.arange(S), 3000 - 5 * np.arange(S)]).astype(np.int32)
    want = ref_attn._mla_qkr(_j(params), jnp.asarray(x), jnp.asarray(pos),
                             cfg)
    got = t_attn._mla_qkr(_t(params), torch.tensor(x), torch.tensor(pos),
                          _to_port_config(cfg))
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, name)


def test_rms_eps_is_fixed():
    """The latents' norm uses eps 1e-5 whatever cfg.norm_eps says."""
    x = np.full((1, 3), 1e-3, np.float32)
    s = np.ones(3, np.float32)
    want = ref_attn._rms(jnp.asarray(x), jnp.asarray(s))
    got = t_attn._rms(torch.tensor(x), torch.tensor(s))
    _close(got, want, "rms", atol=1e-6)
    assert float(got[0, 0]) < 0.5          # eps 1e-5 dominates 1e-6


@pytest.mark.parametrize("chunk", [1024, 16])   # 16 is halved to 8 at S=40
@pytest.mark.parametrize("which", list(ARCHS))
def test_mla_forward_matches(which, chunk):
    cfg, params = _setup(which)
    B, S = 2, 40
    x = _x(cfg, B, S, 2)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = ref_attn.mla_forward(_j(params), jnp.asarray(x), jnp.asarray(pos),
                                cfg, chunk=chunk)
    out, c_kv, k_rope = t_attn.mla_forward(
        _t(params), torch.tensor(x), torch.tensor(pos), _to_port_config(cfg),
        chunk=chunk, return_kv=True)
    _close(out, want, "mla_forward")
    _, _, ckv_want, kr_want = ref_attn._mla_qkr(
        _j(params), jnp.asarray(x), jnp.asarray(pos), cfg)
    _close(c_kv, ckv_want, "c_kv")
    _close(k_rope, kr_want, "k_rope")


@pytest.mark.parametrize("pos", [0, 17, 31, 32, 40])   # C = 32: 32, 40 clamp
@pytest.mark.parametrize("which", list(ARCHS))
def test_mla_decode_matches(which, pos):
    cfg, params = _setup(which)
    m = cfg.mla
    B, C = 2, 32
    rng_ = np.random.default_rng(pos)
    x = _x(cfg, B, 1, 3 + pos)
    ckv = rng_.standard_normal((B, C, m.kv_lora_rank)).astype(np.float32)
    kr = rng_.standard_normal((B, C, m.qk_rope_head_dim)).astype(np.float32)
    want, want_ckv, want_kr = ref_attn.mla_decode(
        _j(params), jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.asarray(pos, jnp.int32), cfg)
    t_ckv, t_kr = torch.tensor(ckv), torch.tensor(kr)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    slot = t_attn.mla_decode_slot(pos_t, C)
    assert slot.dtype == torch.int64 and int(slot) == min(pos, C - 1)
    got = t_attn.mla_decode(_t(params), torch.tensor(x), t_ckv, t_kr, pos_t,
                            slot, _to_port_config(cfg))
    _close(got, want, "mla_decode out")
    _close(t_ckv, want_ckv, "c_kv cache")
    _close(t_kr, want_kr, "k_rope cache")
    # every slot but the written one is left as it was
    keep = np.arange(C) != min(pos, C - 1)
    np.testing.assert_array_equal(t_ckv.numpy()[:, keep], ckv[:, keep])


def test_mla_init_cache_matches_reference():
    cfg = ref_registry.get_config("minicpm3-4b").reduced()
    want = ref_attn.mla_init_cache(cfg, 3, 50, 2, jnp.float32)
    got = t_attn.mla_init_cache(_to_port_config(cfg), 3, 50, 2,
                                torch.float32)
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).replace("torch.", "") == \
            str(want[name].dtype), name
        assert not got[name].any()


def test_whole_minicpm3_matches_reference(monkeypatch):
    port = whole_model_matches("minicpm3-4b", 24, monkeypatch)
    assert float(port.last_aux) == 0.0          # no MoE layer


@pytest.mark.parametrize("S", [24, 40])
def test_decode_matches_forward(S):
    """prefill + 4 decode steps == the full forward, on the port alone."""
    cfg = t_registry.get_config("minicpm3-4b").reduced()
    gen = rng(1, "cpu")
    model = Model.init(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 4), generator=gen)
    with torch.no_grad():
        full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :S])
    torch.testing.assert_close(logits, full[:, S - 1], atol=2e-2, rtol=2e-2)
    for t in range(4):
        logits, cache = model.decode_step(toks[:, S + t], cache)
        torch.testing.assert_close(logits, full[:, S + t], atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_unported_families_name_their_item(arch):
    cfg = _to_port_config(ref_registry.get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item "
                       "19d"):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match="19d"):
        Model.init(cfg, torch.Generator())


def test_attention_and_family_must_agree():
    cfg = _to_port_config(ref_registry.get_config("minicpm3-4b").reduced())
    with pytest.raises(NotImplementedError, match="mla"):
        check_supported(dataclasses.replace(cfg, mla=None))
    with pytest.raises(NotImplementedError, match="moe"):
        check_supported(dataclasses.replace(cfg, family="moe"))
