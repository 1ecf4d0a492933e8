"""Mamba2 (SSD) and the hybrid family on the CPU, held against the JAX
reference: ``mamba2_init`` shapes, the conv and the gated norm, the
chunked ``mamba2_forward`` at a chunk of 1 (S = 37), two chunks (S = 64)
and the conv tail's own branch (S = 2 < K - 1), with and without
``h_init``, at one group and at two; ``mamba2_decode`` for 8 steps from a
prefill state; the chunked path against the port's own step-by-step
decode; reduced zamba2-1.2b whole (forward, prefill with every cache
entry, 8 greedy decode steps), also at 5 layers with the shared block
every 2 (a trailing group without attention); ``model_params_from_numpy``
on a bf16 tree; the serve entry.  Decode attention runs K8's plain
version here (CPU tensors).

Tolerances: the layer and the whole model atol = rtol = 1e-4 (as
tests/test_torch_moe.py: the same f32 products, sums in another order);
the chunked path against step-by-step decode atol 2e-3, rtol 2e-2 (the
reference's own test of the same, tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import ssm as ref_ssm
from repro_torch import convert
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import ssm as t_ssm
from repro_torch.models.model import Model, _hybrid_groups
from test_torch_models import _to_port_config

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(groups=1):
    cfg = ref_registry.get_config("zamba2-1.2b").reduced()
    if groups != 1:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, ngroups=groups))
    return cfg


def _params(cfg, seed=0):
    """The reference's Mamba2 init as numpy leaves, with a spread A_log,
    dt_bias and D (its init sets them constant) so every head decays at
    its own rate."""
    p = jax.tree.map(np.asarray, ref_ssm.mamba2_init(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng_ = np.random.default_rng(seed + 100)
    H = p["A_log"].shape[0]
    p["A_log"] = rng_.uniform(-1.0, 1.0, H).astype(np.float32)
    p["dt_bias"] = rng_.uniform(-2.0, 0.5, H).astype(np.float32)
    p["D"] = rng_.uniform(0.5, 1.5, H).astype(np.float32)
    return p


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _x(cfg, B, S, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def test_mamba2_init_shapes_match_reference():
    for dtype in ("float32", "bfloat16"):
        cfg = _cfg()
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            ref_ssm.mamba2_init(jax.random.PRNGKey(0), cfg,
                                                jnp.dtype(dtype)))
        got = t_ssm.mamba2_init(torch.Generator().manual_seed(0),
                                _to_port_config(cfg), getattr(torch, dtype))
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in got.items()}
        assert got == want, dtype
        assert got["A_log"][1] == "float32"


@pytest.mark.parametrize("S", [2, 5])
def test_causal_conv_and_gated_norm_match(S):
    rng_ = np.random.default_rng(S)
    x = rng_.standard_normal((2, S, 12)).astype(np.float32)
    w = rng_.standard_normal((4, 12)).astype(np.float32)
    b = rng_.standard_normal(12).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = t_ssm._causal_conv(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b))
    _close(got, want, "conv", dict(atol=1e-6, rtol=0))
    z = rng_.standard_normal((2, S, 12)).astype(np.float32)
    want = ref_ssm._gated_norm(jnp.asarray(x), jnp.asarray(z),
                               jnp.asarray(b))
    got = t_ssm._gated_norm(torch.tensor(x), torch.tensor(z),
                            torch.tensor(b))
    _close(got, want, "gated norm", dict(atol=1e-6, rtol=1e-6))


@pytest.mark.parametrize("S,Q", [(37, 1), (64, 32), (2, 2), (48, 16)])
def test_chunk_length_follows_the_reference(S, Q):
    assert t_ssm._chunk_len(S, _cfg().ssm.chunk) == Q


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("S", [37, 64, 2])
def test_mamba2_forward_matches(S, with_h, groups):
    cfg = _cfg(groups)
    p = _params(cfg)
    x = _x(cfg, 2, S, S)
    d_inner, H, N, G = ref_ssm.ssm_dims(cfg)
    assert G == groups
    h0 = None
    if with_h:
        h0 = (0.3 * np.random.default_rng(7).standard_normal(
            (2, H, cfg.ssm.headdim, N))).astype(np.float32)
    want, wst = ref_ssm.mamba2_forward(
        _j(p), jnp.asarray(x), cfg,
        h_init=None if h0 is None else jnp.asarray(h0))
    got, st = t_ssm.mamba2_forward(
        _t(p), torch.tensor(x), _to_port_config(cfg),
        h_init=None if h0 is None else torch.tensor(h0))
    _close(got, want, "out")
    assert tuple(st["h"].shape) == wst["h"].shape
    assert tuple(st["conv"].shape) == wst["conv"].shape
    _close(st["h"], wst["h"], "h")
    _close(st["conv"], wst["conv"], "conv tail")
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_decode_matches(groups):
    """8 steps from the state a 37-token prefill leaves."""
    cfg = _cfg(groups)
    pcfg = _to_port_config(cfg)
    p = _params(cfg, 1)
    x = _x(cfg, 2, 45, 3)
    _, wst = ref_ssm.mamba2_forward(_j(p), jnp.asarray(x[:, :37]), cfg)
    _, st = t_ssm.mamba2_forward(_t(p), torch.tensor(x[:, :37]), pcfg)
    h_want, conv_want = wst["h"], wst["conv"]
    h, conv = st["h"].clone(), st["conv"].clone()
    for t in range(37, 45):
        want, h_want, conv_want = ref_ssm.mamba2_decode(
            _j(p), jnp.asarray(x[:, t:t + 1]), h_want, conv_want, cfg)
        got = t_ssm.mamba2_decode(_t(p), torch.tensor(x[:, t:t + 1]), h,
                                  conv, pcfg)
        _close(got, want, f"decode out {t}")
        _close(h, h_want, f"decode h {t}")
        _close(conv, conv_want, f"decode conv {t}")


def test_mamba2_init_cache_matches_reference():
    cfg = _cfg()
    want = ref_ssm.mamba2_init_cache(cfg, 3, 4, jnp.float32)
    got = t_ssm.mamba2_init_cache(_to_port_config(cfg), 3, 4, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("S", [37, 64])
def test_chunked_equals_step_by_step(S):
    """The port's chunked SSD == its own decode steps from a zero state
    (the counterpart of tests/test_models.py's)."""
    cfg = _to_port_config(_cfg())
    p = t_ssm.mamba2_init(torch.Generator().manual_seed(4), cfg,
                          torch.float32)
    x = 0.5 * torch.randn((2, S, cfg.d_model),
                          generator=torch.Generator().manual_seed(5))
    out, st = t_ssm.mamba2_forward(p, x, cfg)
    cache = t_ssm.mamba2_init_cache(cfg, 2, 1, torch.float32)
    h, conv = cache["h"][0], cache["conv"][0]
    seq = torch.cat([t_ssm.mamba2_decode(p, x[:, t:t + 1], h, conv, cfg)
                     for t in range(S)], dim=1)
    torch.testing.assert_close(out, seq, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(st["h"], h, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(st["conv"], conv, atol=2e-3, rtol=2e-2)


# ------------------------------------------------------------- whole model


def carry(cfg, seed=1):
    """The reference model, its init, and the port on a copy of it."""
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    pcfg = _to_port_config(cfg)
    port = Model(pcfg, model_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg, "cpu"))
    return ref, params, port


def whole_model_matches(cfg, S, n_dec=8):
    """forward logits, prefill logits and every cache entry, then
    ``n_dec`` greedy decode steps (the reference's argmax fed to both,
    and the port's argmax equal to it) with the caches after them."""
    ref, params, port = carry(cfg)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    want = ref.forward(params, {"tokens": jnp.asarray(toks)})
    got = port.forward(torch.tensor(toks, dtype=torch.int64))
    _close(got.detach(), want, "forward logits")
    assert float(port.last_aux) == 0.0
    want, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks)})
    got, tcache = port.prefill(torch.tensor(toks, dtype=torch.int64))
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
    assert int(tcache["pos"]) == S + n_dec
    return port


@pytest.mark.parametrize("S", [37, 64])
def test_whole_zamba2_matches_reference(S):
    port = whole_model_matches(_cfg(), S)
    assert port.cfg.hybrid_attn_every == 1
    assert port.shared_attn is not None and len(port.blocks) == 2


def test_hybrid_with_a_trailing_group_without_attention():
    """5 Mamba2 layers, the shared block after every 2: groups (0, 2),
    (2, 4) with attention and (4, 5) without; 2 KV slots."""
    cfg = dataclasses.replace(_cfg(), num_layers=5, hybrid_attn_every=2)
    assert _hybrid_groups(_to_port_config(cfg)) == [
        (0, 2, True), (2, 4, True), (4, 5, False)]
    port = whole_model_matches(cfg, 37)
    cache = port.init_cache(2, 40)
    assert cache["attn_k"].shape[0] == 2 and cache["h"].shape[0] == 5


def test_hybrid_groups_of_the_full_config():
    from repro.models.model import _hybrid_groups as ref_groups
    cfg = ref_registry.get_config("zamba2-1.2b")
    got = _hybrid_groups(_to_port_config(cfg))
    assert got == ref_groups(cfg)
    assert got == [(i, i + 6, True) for i in range(0, 36, 6)] + \
        [(36, 38, False)]


def test_port_init_tree_matches_reference():
    """Model.init's params, name for name, the reference init's shapes
    (its layer dim split) and dtypes, at the reduced size in bf16."""
    cfg = dataclasses.replace(_cfg(), param_dtype="bfloat16")
    want = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
    port = Model.init(_to_port_config(cfg), torch.Generator())
    got = dict(port.named_parameters())
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                flat[".".join(["blocks", str(i)] + keys[1:])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            flat[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == flat


# ------------------------------------------------------------- convert


def _bf16_tree(cfg):
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        RefModel(cfg).init(jax.random.PRNGKey(2)))
    return cfg, tree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_convert_carries_a_bf16_tree():
    cfg, tree = _bf16_tree(_cfg())
    pcfg = _to_port_config(cfg)
    params = model_params_from_numpy(tree, pcfg, "cpu")
    assert set(params) == {"embed", "final_norm", "lm_head", "blocks",
                           "shared_attn"}
    for i, bp in enumerate(params["blocks"]):
        assert set(bp) == {"ln", "ssm"}
        for leaf, t in bp["ssm"].items():
            want = tree["blocks"]["ssm"][leaf][i]
            dt = torch.float32 if leaf == "A_log" else torch.bfloat16
            assert t.dtype == dt, leaf
            got = t.view(torch.int16).numpy().view(np.uint16) \
                if dt == torch.bfloat16 else t.numpy()
            assert np.array_equal(got, _bits(want)), leaf
    sh = params["shared_attn"]
    assert set(sh) == {"ln", "attn", "ln2", "mlp"}
    assert np.array_equal(sh["mlp"]["w_up"].view(torch.int16).numpy()
                          .view(np.uint16),
                          _bits(tree["shared_attn"]["mlp"]["w_up"]))
    model = Model(pcfg, params)
    f32 = {n for n, p in model.named_parameters()
           if p.dtype == torch.float32}
    assert f32 == {f"blocks.{i}.ssm.A_log" for i in range(cfg.num_layers)}


def test_convert_refuses_wrong_shape_or_dtype():
    cfg, tree = _bf16_tree(_cfg())
    pcfg = _to_port_config(cfg)
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["ssm"]["A_log"] = tree["blocks"]["ssm"]["A_log"].astype(
        jnp.bfloat16)
    with pytest.raises(TypeError, match="A_log"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["ssm"]["w_in"] = tree["blocks"]["ssm"]["w_in"].astype(
        np.float32)
    with pytest.raises(TypeError, match="w_in"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["ssm"]["conv_w"] = tree["blocks"]["ssm"]["conv_w"][:, 1:]
    with pytest.raises(ValueError, match="conv_w"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["shared_attn"]["attn"]["w_q"] = \
        tree["shared_attn"]["attn"]["w_q"][:, :-1]
    with pytest.raises(ValueError, match="shared_attn.attn.w_q"):
        model_params_from_numpy(bad, pcfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    del bad["shared_attn"]
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(bad, pcfg, "cpu")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_full_size_tree_matches_reference(arch):
    """The full config's tree as ``convert`` expects it against the
    reference init's shapes (``jax.eval_shape``, nothing allocated): every
    leaf's shape and dtype, and the parameter count."""
    cfg = ref_registry.get_config(arch)
    want = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
    pcfg = _to_port_config(cfg)
    L, d = cfg.num_layers, cfg.d_model
    vocab = -(-cfg.vocab_size // 128) * 128
    expect = {("embed", "table"): (vocab, d), ("final_norm", "scale"): (d,),
              ("lm_head", "w"): (d, vocab)}
    expect.update({("blocks",) + p: (L, *s) for p, s in
                   convert._block_shapes(pcfg, moe=False,
                                         d_ff=cfg.d_ff).items()})
    if cfg.family == "hybrid":
        expect.update({("shared_attn",) + p: s for p, s in convert._leaves(
            convert._shared_attn_shapes(pcfg))})
    got = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
           for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert got == {p: (s, str(convert._leaf_dtype(p, torch.bfloat16))
                       .replace("torch.", ""))
                   for p, s in expect.items()}
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == {"zamba2-1.2b": 1_170_473_856,
                 "rwkv6-3b": 3_099_609_600}[arch]


def test_serve_main_on_the_cpu(capsys):
    out = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "40",
                      "--new-tokens", "4", "--seed", "0"])
    assert out["tokens"].shape == (2, 5)
    assert torch.isfinite(out["logits"]).all()
    assert int(out["cache"]["pos"]) == 44
    text = capsys.readouterr().out
    assert "prefill 2x40" in text and "tok/s" in text


@pytest.mark.parametrize("arch,change", [
    ("zamba2-1.2b", dict(hybrid_attn_every=0)),
    ("zamba2-1.2b", dict(ssm=None)),
    ("zamba2-1.2b", dict(attention="none")),
    ("rwkv6-3b", dict(rwkv=None)),
    ("rwkv6-3b", dict(attention="gqa")),
])
def test_family_and_sub_configs_must_agree(arch, change):
    from repro_torch.models.model import check_supported
    cfg = _to_port_config(ref_registry.get_config(arch).reduced())
    check_supported(cfg)
    with pytest.raises(NotImplementedError, match=cfg.family):
        check_supported(dataclasses.replace(cfg, **change))
