"""The dense GQA serving slice on the CPU, held against the JAX reference:
configs field by field, the layers, chunked prefill attention, and the
whole model (prefill plus teacher-forced decode) from one reference init
carried across with ``model_params_from_numpy``.  Decode attention runs
K8's plain version here (CPU tensors).

Tolerances: the layers f32 atol 1e-6 (the same f32 ops, sums in another
order); chunked attention atol 2e-5 (as tests/test_models.py); whole-model
logits and caches f32 atol = rtol = 1e-4 (two layers of matmuls whose sums
XLA and torch order differently); the port against itself atol 2e-2 (as
the reference's own decode-vs-forward test).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import base as t_base
from repro_torch.configs import registry as t_registry
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
SUB = ("moe", "mla", "ssm", "rwkv")


def _to_port_config(cfg) -> t_base.ModelConfig:
    """The port's ModelConfig with the reference config's field values."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, cls in zip(SUB, (t_base.MoEConfig, t_base.MLAConfig,
                               t_base.SSMConfig, t_base.RWKVConfig)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return t_base.ModelConfig(**kw)


def _same_config(a, b):
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("resolved_head_dim", "is_encoder_decoder", "subquadratic"):
        assert getattr(a, prop) == getattr(b, prop), prop


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "MLAConfig",
                                  "SSMConfig", "RWKVConfig"])
def test_config_fields_and_defaults_match(name):
    def spec(cls):
        return [(f.name, f.default, str(f.type))
                for f in dataclasses.fields(cls)]
    assert spec(getattr(t_base, name)) == spec(getattr(ref_base, name))


@pytest.mark.parametrize("arch", [a for a in ref_registry.ARCH_IDS])
def test_reduced_matches_for_every_arch(arch):
    """reduced() of every reference arch, sub-configs included."""
    ref = ref_registry.get_config(arch)
    port = _to_port_config(ref)
    _same_config(port, ref)
    _same_config(port.reduced(), ref.reduced())


@pytest.mark.parametrize("arch", t_registry.PORTED_ARCH_IDS)
def test_registry_matches_reference(arch):
    _same_config(t_registry.get_config(arch), ref_registry.get_config(arch))


def test_registry_refuses_what_is_not_ported():
    assert t_registry.ARCH_IDS == ref_registry.ARCH_IDS
    for arch in set(t_registry.ARCH_IDS) - set(t_registry.PORTED_ARCH_IDS):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_registry.get_config(arch)
    with pytest.raises(KeyError):
        t_registry.get_config("gpt-5")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 19d"):
        Model.init(_to_port_config(
            ref_registry.get_config("llava-next-mistral-7b").reduced()),
            torch.Generator())


# ------------------------------------------------------------------- layers


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_rms_norm_matches():
    x, s = _np((3, 5, 64), 0, 3.0), _np((64,), 1)
    want = ref_layers.rms_norm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = t_layers.rms_norm({"scale": torch.tensor(s)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
@pytest.mark.parametrize("dh", [64, 96, 128])
def test_apply_rope_matches(dh, theta):
    S = 40
    x = _np((2, S, 3, dh), dh)
    pos = np.stack([np.arange(S), 5000 - 7 * np.arange(S)]).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_layers.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_swiglu_matches():
    d, ff = 64, 128
    p = {"w_gate": _np((d, ff), 1, d ** -0.5), "w_up": _np((d, ff), 2, d ** -0.5),
         "w_down": _np((ff, d), 3, ff ** -0.5)}
    x = _np((2, 7, d), 4)
    want = ref_layers.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = t_layers.swiglu({k: torch.tensor(v) for k, v in p.items()},
                          torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_chunked_prefill_attention_matches():
    """Reduced phi3 (window 64), S = 130 in chunks of 32 (halved to 2), as
    tests/test_models.py:101 runs the reference."""
    cfg = ref_registry.get_config("phi3-mini-3.8b").reduced()
    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    kvd = cfg.num_kv_heads * cfg.resolved_head_dim
    p = {"w_q": _np((d, hd), 1, d ** -0.5), "w_k": _np((d, kvd), 2, d ** -0.5),
         "w_v": _np((d, kvd), 3, d ** -0.5), "w_o": _np((hd, d), 4, hd ** -0.5)}
    B, S = 2, 130
    x = _np((B, S, d), 5)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = ref_attn.gqa_forward({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(pos), cfg,
                                chunk=32)
    got = t_attn.gqa_forward({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x), torch.tensor(pos),
                             _to_port_config(cfg), chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_short_prompt_window_prefill():
    """window < S < chunk + window: the reference's key slice would be
    longer than the prompt; the port attends over the masked prefix, which
    the reference gives with a smaller chunk."""
    cfg = ref_registry.get_config("phi3-mini-3.8b").reduced()
    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    p = {"w_q": _np((d, hd), 1, d ** -0.5), "w_k": _np((d, hd), 2, d ** -0.5),
         "w_v": _np((d, hd), 3, d ** -0.5), "w_o": _np((hd, d), 4, hd ** -0.5)}
    B, S = 2, 96
    x = _np((B, S, d), 6)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = ref_attn.gqa_forward({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(pos), cfg,
                                chunk=32)
    got = t_attn.gqa_forward({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x), torch.tensor(pos),
                             _to_port_config(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# ------------------------------------------------------------- whole model


def _carry(arch):
    cfg = ref_registry.get_config(arch).reduced()
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    port = Model(_to_port_config(cfg),
                 model_params_from_numpy(tree, _to_port_config(cfg), "cpu"))
    return cfg, ref, params, port


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=1e-4,
                               rtol=1e-4, err_msg=what)


@pytest.mark.parametrize("arch,S", [
    ("phi3-mini-3.8b", 96),   # window 64: C = 64, the ring has wrapped
    ("phi3-mini-3.8b", 24),   # C = 64, nvalid partial and growing
    ("smollm-135m", 24),      # KV 2 < H 4, tied embeddings, no window
])
def test_prefill_and_decode_match_reference(arch, S, monkeypatch):
    cfg, ref, params, port = _carry(arch)
    # the reference's prefill needs chunk + window <= S (see
    # test_short_prompt_window_prefill): a smaller chunk, the same attention
    monkeypatch.setattr(ref_attn, "gqa_forward",
                        functools.partial(ref_attn.gqa_forward, chunk=32))
    n_dec = 8
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S + n_dec)).astype(np.int32)
    want, rcache = jax.jit(ref.prefill)(params,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    got, tcache = port.prefill(torch.tensor(toks[:, :S], dtype=torch.int64))
    assert got.shape == want.shape == (2, port.padded_vocab)
    _close(got, want, "prefill logits")
    decode = jax.jit(ref.decode_step)
    for t in range(n_dec):
        tok = toks[:, S + t]
        want, rcache = decode(params, jnp.asarray(tok), rcache)
        got, tcache = port.decode_step(torch.tensor(tok, dtype=torch.int64),
                                       tcache)
        _close(got, want, f"decode step {t}")
    assert tcache["k"].shape == rcache["k"].shape
    assert int(tcache["pos"]) == int(rcache["pos"]) == S + n_dec
    _close(tcache["k"], rcache["k"], "cache k")
    _close(tcache["v"], rcache["v"], "cache v")


@pytest.mark.parametrize("arch,S", [("phi3-mini-3.8b", 24),
                                    ("phi3-mini-3.8b", 96),
                                    ("smollm-135m", 24), ("yi-6b", 24)])
def test_decode_matches_forward(arch, S):
    """prefill + N decode steps == the full forward (teacher forcing), on
    the port alone, as tests/test_models.py:60 holds the reference."""
    from repro_torch import rng
    cfg = t_registry.get_config(arch).reduced()
    gen = rng(1, "cpu")
    model = Model.init(cfg, gen)
    n_dec = 4
    toks = torch.randint(0, cfg.vocab_size, (2, S + n_dec), generator=gen)
    with torch.no_grad():
        full = model.forward(toks)
    logits, cache = model.prefill(toks[:, :S])
    torch.testing.assert_close(logits, full[:, S - 1], atol=2e-2, rtol=2e-2)
    for t in range(n_dec):
        logits, cache = model.decode_step(toks[:, S + t], cache)
        torch.testing.assert_close(logits, full[:, S + t], atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("pos,C", [(0, 64), (23, 64), (63, 64), (64, 64),
                                   (4095 + 31, 2047), (1000, 1064)])
def test_decode_slots_match_reference(pos, C):
    """The slot a step writes and its live count, computed once a step, are
    the reference's ``pos % C`` and ``min(pos + 1, C)`` (attention.py:138)."""
    slot, nvalid = t_attn.gqa_decode_slots(
        torch.tensor(pos, dtype=torch.int32), C)
    assert slot.dtype == torch.int64 and slot.shape == (1,)
    assert nvalid.dtype == torch.int32 and nvalid.shape == (1,)
    assert int(slot) == int(jnp.asarray(pos, jnp.int32) % C)
    assert int(nvalid) == int(jnp.minimum(jnp.asarray(pos, jnp.int32) + 1, C))


def test_params_from_numpy_checks_shapes_and_dtypes():
    cfg, _, params, _ = _carry("smollm-135m")
    tree = jax.tree.map(np.asarray, params)
    pcfg = _to_port_config(cfg)
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"]["attn"]["w_q"] = tree["blocks"]["attn"]["w_q"][:, :, :-1]
    with pytest.raises(ValueError, match="w_q"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad["blocks"]["attn"]["w_q"] = tree["blocks"]["attn"]["w_q"].astype(
        np.float16)
    with pytest.raises(TypeError, match="w_q"):
        model_params_from_numpy(bad, pcfg, "cpu")
    params_bf16 = RefModel(dataclasses.replace(cfg, param_dtype="bfloat16")
                           ).init(jax.random.PRNGKey(2))
    out = model_params_from_numpy(
        jax.tree.map(np.asarray, params_bf16),
        dataclasses.replace(pcfg, param_dtype="bfloat16"), "cpu")
    w = out["blocks"][1]["mlp"]["w_up"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(params_bf16["blocks"]["mlp"]["w_up"][1], np.float32))


# --------------------------------------------------------------------- CLI


def _serve(*args, cuda_visible=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--batch", "2", "--prompt-len", "80", "--new-tokens", "4", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_on_the_cpu():
    res = _serve("--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "prefill 2x80" in res.stdout and "tok/s" in res.stdout


def test_serve_cli_without_a_card_raises():
    res = _serve(cuda_visible="")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
