"""The vlm family (llava-next-mistral-7b) and the audio one (whisper-tiny)
on the CPU, held against the JAX reference: the LayerNorm, the GELU MLP,
cross-attention and the sinusoidal table; ``gqa_forward`` without rope,
not causal and over a separate K/V source; reduced llava and whisper whole
(forward, prefill with every cache entry, 8 greedy decode steps), the
converted trees, the init trees against ``jax.eval_shape``; the serve
entry.  Decode self-attention runs K8's plain version here (CPU tensors).

Tolerances: the layers atol 1e-6 and rtol 4e-6 (the same f32 products,
summed in another order by XLA's and torch's CPU matmuls: a few ulps of
outputs near 1, where the sums differ by up to 3e-6); the whole
models atol = rtol = 1e-4 (as tests/test_torch_ssm.py: sums in another
order through several layers); the sinusoidal table exactly (both compute
it in f64 on the host and round once).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch.configs import registry as t_registry
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models.model import Model
from test_torch_models import _same_config, _to_port_config

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-6, rtol=4e-6)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


# ------------------------------------------------------------------ layers


def test_layer_norm_matches():
    x, s, b = _np((3, 5, 64), 0, 3.0), _np((64,), 1), _np((64,), 2)
    want = ref_layers.layer_norm({"scale": jnp.asarray(s),
                                  "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = t_layers.layer_norm({"scale": torch.tensor(s),
                               "bias": torch.tensor(b)}, torch.tensor(x))
    _close(got, want, "layer_norm", LAYER_TOL)


def test_layer_norm_uses_the_population_variance():
    x = torch.tensor([[1.0, 3.0]])
    p = t_layers.layer_norm_init(2, torch.float32)
    got = t_layers.layer_norm(p, x, eps=0.0)
    torch.testing.assert_close(got, torch.tensor([[-1.0, 1.0]]))


def test_gelu_mlp_matches_the_tanh_gelu():
    p = {"w_in": _np((32, 48), 0, 0.3), "b_in": _np((48,), 1, 0.1),
         "w_out": _np((48, 32), 2, 0.3), "b_out": _np((32,), 3, 0.1)}
    x = _np((2, 7, 32), 4, 2.0)
    want = ref_layers.gelu_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = t_layers.gelu_mlp({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x))
    _close(got, want, "gelu_mlp", LAYER_TOL)


def test_inits_have_the_reference_shapes():
    gen = torch.Generator()
    ln = t_layers.layer_norm_init(16, torch.bfloat16)
    want = ref_layers.layer_norm_init(16, jnp.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in ln.items()} == {
        k: (v.shape, torch.bfloat16) for k, v in want.items()}
    mlp = t_layers.gelu_mlp_init(gen, 16, 40, torch.float32)
    want = jax.eval_shape(lambda k: ref_layers.gelu_mlp_init(
        k, 16, 40, jnp.float32), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in mlp.items()} == \
        {k: v.shape for k, v in want.items()}


def _attn_cfg(kv=2):
    cfg = ref_registry.get_config("whisper-tiny").reduced()
    return dataclasses.replace(cfg, num_kv_heads=kv)


def _attn_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_attn.gqa_init(
        jax.random.PRNGKey(seed), cfg, jnp.float32))


@pytest.mark.parametrize("kv", [4, 2])
def test_cross_attend_and_cross_kv_match(kv):
    cfg = _attn_cfg(kv)
    p = _attn_params(cfg)
    x, enc = _np((2, 5, cfg.d_model), 1), _np((2, 11, cfg.d_model), 2)
    rk, rv = ref_attn.cross_kv(jax.tree.map(jnp.asarray, p),
                               jnp.asarray(enc), cfg)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tk, tv = t_attn.cross_kv(tp, torch.tensor(enc), _to_port_config(cfg))
    _close(tk, rk, "cross K", LAYER_TOL)
    _close(tv, rv, "cross V", LAYER_TOL)
    want = ref_attn.cross_attend(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), rk, rv, cfg)
    got = t_attn.cross_attend(tp, torch.tensor(x), tk, tv,
                              _to_port_config(cfg))
    _close(got, want, "cross_attend", LAYER_TOL)


@pytest.mark.parametrize("kw", [dict(use_rope=False, causal=True),
                                dict(use_rope=False, causal=False),
                                dict(use_rope=True, causal=False),
                                dict(use_rope=False, causal=False,
                                     kv_src=True)])
def test_gqa_forward_variants_match(kw):
    cfg = _attn_cfg(2)
    p = _attn_params(cfg, 3)
    x = _np((2, 9, cfg.d_model), 4)
    kv_src = _np((2, 13, cfg.d_model), 5) if kw.pop("kv_src", None) else None
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want = ref_attn.gqa_forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg,
        kv_src=None if kv_src is None else jnp.asarray(kv_src), **kw)
    got = t_attn.gqa_forward(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
        torch.tensor(pos), _to_port_config(cfg),
        kv_src=None if kv_src is None else torch.tensor(kv_src), **kw)
    _close(got, want, f"gqa_forward {kw}", dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("length,dim", [(64, 256), (1500, 384), (7, 6)])
def test_sinusoidal_matches_exactly(length, dim):
    want = np.asarray(ref_model._sinusoidal(length, dim))
    got = t_model.sinusoidal(length, dim).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------------ models


def _cfg(arch):
    return ref_registry.get_config(arch).reduced()


def carry(cfg, seed=1):
    """The reference model, its init, and the port on a copy of it."""
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    pcfg = _to_port_config(cfg)
    port = Model(pcfg, model_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg, "cpu"))
    return ref, params, port


def _inputs(cfg, B, seed):
    """The family's stub input, as the reference's batch entry and the
    port's keyword."""
    if cfg.family == "vlm":
        x = _np((B, cfg.num_image_tokens, cfg.d_model), seed, 0.1)
        return {"image_embeds": x}
    return {"frames": _np((B, cfg.encoder_seq_len, cfg.d_model), seed, 0.1)}


def whole_model_matches(arch, S, monkeypatch, n_dec=8):
    """forward logits, prefill logits and every cache entry, then
    ``n_dec`` greedy decode steps (the reference's argmax fed to both,
    and the port's argmax equal to it) with the caches after them."""
    # the reference's SWA prefill needs chunk + window <= S
    # (tests/test_torch_models.py::test_short_prompt_window_prefill)
    monkeypatch.setattr(ref_attn, "gqa_forward",
                        functools.partial(ref_attn.gqa_forward, chunk=32))
    cfg = _cfg(arch)
    ref, params, port = carry(cfg)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    extra = _inputs(cfg, 2, S + 1)
    rbatch = {"tokens": jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    tkw = {k: torch.tensor(v) for k, v in extra.items()}
    ttoks = torch.tensor(toks, dtype=torch.int64)
    want = ref.forward(params, rbatch)
    got = port.forward(ttoks, **tkw)
    _close(got.detach(), want, "forward logits")
    want, rcache = jax.jit(ref.prefill)(params, rbatch)
    got, tcache = port.prefill(ttoks, **tkw)
    assert got.shape == want.shape == (2, port.padded_vocab)
    _close(got, want, "prefill logits")
    assert set(tcache) == set(rcache)
    for name in tcache:
        assert tuple(tcache[name].shape) == tuple(rcache[name].shape), name
        assert str(tcache[name].dtype).replace("torch.", "") == \
            str(rcache[name].dtype), name
        _close(tcache[name], rcache[name], f"prefill cache {name}")
    decode = jax.jit(ref.decode_step)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    for t in range(n_dec):
        assert np.array_equal(got.argmax(-1).numpy(), tok), t
        want, rcache = decode(params, jnp.asarray(tok), rcache)
        got, tcache = port.decode_step(torch.tensor(tok, dtype=torch.int64),
                                       tcache)
        _close(got, want, f"decode step {t}")
        tok = np.asarray(want).argmax(-1).astype(np.int32)
    for name in tcache:
        _close(tcache[name], rcache[name], f"cache {name}")
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    assert int(tcache["pos"]) == n_img + S + n_dec
    return port, tcache


def test_whole_llava_matches_reference(monkeypatch):
    """16 image tokens + 80 text tokens past the window of 64: the ring
    wrapped before decode starts."""
    port, cache = whole_model_matches("llava-next-mistral-7b", 80,
                                      monkeypatch)
    assert cache["k"].shape[2] == 64 == port.cfg.sliding_window


@pytest.mark.parametrize("S", [24, 40])
def test_whole_whisper_matches_reference(S, monkeypatch):
    port, cache = whole_model_matches("whisper-tiny", S, monkeypatch)
    assert cache["xk"].shape[2] == port.cfg.encoder_seq_len
    assert port.dec_pos.shape == (1 << 16, port.cfg.d_model)


def _bf16_close(got, want, what):
    """Within two bf16 ulps at the top of the reference's range (atol
    2^-6 max|want|): each side rounds every product and sum to bf16, in
    another order."""
    want = np.asarray(want, np.float32)
    _close(got.detach().float(), want, what,
           dict(atol=2.0 ** -6 * float(np.abs(want).max()), rtol=0))


def test_bf16_whisper_runs_its_encoder_in_f32_as_the_reference():
    """A bf16 whisper on f32 frames (as served): the reference's type
    promotion runs the encoder, and so the cross K/V, in f32.  The port's
    encoder output and cross K/V cache are f32 and agree at the whole
    models' f32 tolerance; the bf16 logits and self-attention K/V within
    two bf16 ulps of the reference's top value."""
    cfg = dataclasses.replace(_cfg("whisper-tiny"), param_dtype="bfloat16")
    ref, params, port = carry(cfg)
    frames = _np((2, cfg.encoder_seq_len, cfg.d_model), 7, 0.1)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    want = ref._encode(params, jnp.asarray(frames))
    got = port._encode(torch.tensor(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, "encoder output")
    rbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    ttoks = torch.tensor(toks, dtype=torch.int64)
    _bf16_close(port.forward(ttoks, frames=torch.tensor(frames)),
                ref.forward(params, rbatch), "forward logits")
    want, rcache = jax.jit(ref.prefill)(params, rbatch)
    got, tcache = port.prefill(ttoks, frames=torch.tensor(frames))
    _bf16_close(got, want, "prefill logits")
    for name in ("k", "v", "xk", "xv"):
        assert str(tcache[name].dtype).replace("torch.", "") == \
            str(rcache[name].dtype), name
    for name in ("xk", "xv"):
        _close(tcache[name], rcache[name], f"prefill cache {name}")
    for name in ("k", "v"):
        _bf16_close(tcache[name], rcache[name], f"prefill cache {name}")


def test_whisper_decode_positions_wrap_on_the_device(monkeypatch):
    """A decode step at pos past the table's rows adds row pos mod rows,
    read on the device (the cache position stays a tensor)."""
    cfg = _to_port_config(dataclasses.replace(_cfg("whisper-tiny"),
                                              max_seq_len=48))
    port = Model.init(cfg, torch.Generator().manual_seed(0))
    assert port.dec_pos.shape[0] == 48
    frames = torch.tensor(_np((1, cfg.encoder_seq_len, cfg.d_model), 0, 0.1))
    _, cache = port.prefill(torch.zeros((1, 4), dtype=torch.int64), 60,
                            frames=frames)
    seen = []

    def tap(x, cache):
        seen.append(x.clone())
        return x
    monkeypatch.setattr(port, "_decode_whisper", tap)
    tok = torch.tensor([3])
    emb = port.embed["table"][3]
    for pos in (50, 2, 47):
        cache["pos"].fill_(pos)
        port.decode_step(tok, cache)
        torch.testing.assert_close(seen[-1][0, 0],
                                   emb + port.dec_pos[pos % 48],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_port_init_tree_matches_reference(arch):
    """Model.init's params, name for name, the reference init's shapes
    (its layer dims split) and dtypes, at the reduced size in bf16."""
    cfg = dataclasses.replace(_cfg(arch), param_dtype="bfloat16")
    want = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
    port = Model.init(_to_port_config(cfg), torch.Generator())
    got = dict(port.named_parameters())
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("blocks", "enc_blocks"):
            for i in range(leaf.shape[0]):
                flat[".".join([keys[0], str(i)] + keys[1:])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            flat[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == flat


def test_convert_rejects_a_tree_without_the_encoder():
    cfg = _cfg("whisper-tiny")
    params = jax.tree.map(np.asarray, RefModel(cfg).init(
        jax.random.PRNGKey(0)))
    del params["enc_norm"]
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(params, _to_port_config(cfg), "cpu")


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_registry_config_matches_reference(arch):
    _same_config(t_registry.get_config(arch), ref_registry.get_config(arch))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_serve_entry_runs_the_family(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12",
                      "--new-tokens", "3"])
    assert out["tokens"].shape == (2, 4)
    cfg = t_registry.get_config(arch).reduced()
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    assert int(out["cache"]["pos"]) == n_img + 12 + 3
    assert "tok/s" in capsys.readouterr().out


def test_stub_inputs_have_the_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    llava = t_registry.get_config("llava-next-mistral-7b")
    whisper = t_registry.get_config("whisper-tiny")
    assert serve.stub_inputs(llava, 3, gen)["image_embeds"].shape == \
        (3, 2880, 4096)
    assert serve.stub_inputs(whisper, 2, gen)["frames"].shape == \
        (2, 1500, 384)
    assert serve.stub_inputs(t_registry.get_config("yi-6b"), 2, gen) == {}
