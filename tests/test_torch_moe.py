"""The MoE layer and the MoE models on the CPU, held against the JAX
reference: ``capacity``, ``moe_forward`` (global and row dispatch, with
drops and shared experts), and reduced mixtral-8x7b and
deepseek-v2-lite-16b whole (forward with its router aux, prefill and
teacher-forced decode) from one reference init carried across with
``model_params_from_numpy``.  Decode attention runs K8's plain version
here (CPU tensors).

Tolerances: the MoE layer f32 atol 1e-5 (the reference's parity contract:
the same products, sums in another order); whole-model logits, caches and
aux f32 atol = rtol = 1e-4 (as tests/test_torch_models.py); the port
against itself atol 2e-2 (as the reference's own decode-vs-forward test).
Routing is discrete: every input here keeps a top-k margin over 1e-4, so
float order cannot flip a route (the test fails, rather than reseeds, if
it does not).
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
from repro.models import moe as ref_moe
from repro_torch import rng
from repro_torch.configs import registry as t_registry
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import moe as t_moe
from repro_torch.models.model import Model
from test_torch_models import _to_port_config

MARGIN = 1e-4


def _moe_cfg(arch, **moe_kw):
    cfg = ref_registry.get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **moe_kw))


def _moe_params(cfg, seed=0):
    """The reference's MoE init in f32, as numpy leaves."""
    tree = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _require_margin(params, x, m):
    """Every token's k-th routing probability exceeds its (k+1)-th by more
    than MARGIN (on the reference's probabilities)."""
    logits = x.reshape(-1, x.shape[-1]) @ params["router"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top = -np.sort(-probs, axis=-1)
    margin = float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
    assert margin > MARGIN, f"top-k margin {margin} of the inputs"


# ---------------------------------------------------------------- capacity


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_matches(cf):
    for T in (1, 4, 7, 48, 192, 1000, 16384):
        for E, k in ((4, 2), (8, 2), (64, 6), (16, 6), (2, 1)):
            rcfg = ref_registry.get_config("mixtral-8x7b").moe
            m = dataclasses.replace(rcfg, num_experts=E, top_k=k,
                                    capacity_factor=cf)
            tm = _to_port_config(dataclasses.replace(
                ref_registry.get_config("mixtral-8x7b"), moe=m)).moe
            assert t_moe.capacity(T, tm) == ref_moe.capacity(T, m), (T, E, k)


# --------------------------------------------------------------- the layer


CASES = {
    # (arch, moe overrides, B, S): reduced mixtral (4 experts top-2),
    # reduced deepseek (a shared expert) and deepseek's own top-6 routing
    "mixtral": ("mixtral-8x7b", {}, 2, 24),
    "mixtral-drops": ("mixtral-8x7b", {"capacity_factor": 0.5}, 2, 24),
    "deepseek": ("deepseek-v2-lite-16b", {}, 2, 24),
    "deepseek-drops": ("deepseek-v2-lite-16b", {"capacity_factor": 0.5},
                       2, 24),
    "deepseek-top6": ("deepseek-v2-lite-16b",
                      {"num_experts": 16, "top_k": 6}, 2, 24),
    "deepseek-top6-drops": ("deepseek-v2-lite-16b",
                            {"num_experts": 16, "top_k": 6,
                             "capacity_factor": 0.5}, 2, 24),
}


@pytest.mark.parametrize("dispatch", ["global", "row"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches(case, dispatch):
    arch, kw, B, S = CASES[case]
    cfg = _moe_cfg(arch, dispatch=dispatch, **kw)
    params = _moe_params(cfg)
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    _require_margin(params, x, cfg.moe)
    want, want_aux = ref_moe.moe_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg)
    stats = {}
    got, got_aux = t_moe.moe_forward(_torch_tree(params), torch.tensor(x),
                                     _to_port_config(cfg), stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5,
                               rtol=0)
    pools = B if dispatch == "row" else 1
    assert stats["entries"] == B * S * cfg.moe.top_k
    if cfg.moe.capacity_factor < 1:
        # a pool of T tokens keeps at most E C entries: some must drop
        T = B * S // pools
        kept = cfg.moe.num_experts * ref_moe.capacity(T, cfg.moe)
        assert kept < T * cfg.moe.top_k
        assert int(stats["dropped"]) >= pools * (T * cfg.moe.top_k - kept)


def test_moe_drops_follow_token_order():
    """With capacity short, each expert keeps its earliest tokens: a
    token's output is its shared part plus only the kept experts' terms."""
    cfg = _to_port_config(_moe_cfg("mixtral-8x7b", capacity_factor=0.5))
    params = _torch_tree(_moe_params(cfg))
    xf = torch.tensor(np.random.default_rng(3).standard_normal(
        (48, cfg.d_model)).astype(np.float32))
    out, _ = t_moe._moe_tokens(params, xf, cfg)
    _, gates, idx = t_moe.route(params, xf, cfg.moe)
    C = t_moe.capacity(48, cfg.moe)
    seen = [0] * cfg.moe.num_experts
    for t in range(48):
        want = torch.zeros(cfg.d_model)
        for j in range(cfg.moe.top_k):
            e = int(idx[t, j])
            if seen[e] < C:
                h = torch.nn.functional.silu(xf[t] @ params["w_gate"][e]) \
                    * (xf[t] @ params["w_up"][e])
                want += gates[t, j] * (h @ params["w_down"][e])
            seen[e] += 1
        torch.testing.assert_close(out[t], want, atol=1e-5, rtol=0)
    assert max(seen) > C


def test_moe_row_dispatch_matches_global():
    """Row dispatch == global dispatch when capacity is drop-free (the
    counterpart of tests/test_models.py's)."""
    cfg = ref_registry.get_config("deepseek-v2-lite-16b").reduced()
    E = cfg.moe.num_experts
    base = _to_port_config(_moe_cfg("deepseek-v2-lite-16b",
                                    capacity_factor=float(E)))
    row = _to_port_config(_moe_cfg("deepseek-v2-lite-16b",
                                   capacity_factor=float(E),
                                   dispatch="row"))
    params = _torch_tree(_moe_params(base))
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (3, 32, cfg.d_model)).astype(np.float32))
    o1, _ = t_moe.moe_forward(params, x, base)
    o2, _ = t_moe.moe_forward(params, x, row)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)


def test_moe_init_shapes_match_reference():
    for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b"):
        cfg = ref_registry.get_config(arch).reduced()
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            ref_moe.moe_init(jax.random.PRNGKey(0), cfg,
                                             jnp.float32))
        got = t_moe.moe_init(torch.Generator().manual_seed(0),
                             _to_port_config(cfg), torch.float32)
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).replace("torch.", "")),
                           got)
        assert got == want, arch


# ------------------------------------------------------------- whole model


def _carry(arch, **moe_kw):
    cfg = ref_registry.get_config(arch).reduced()
    if moe_kw:
        cfg = _moe_cfg(arch, **moe_kw)
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(1))
    pcfg = _to_port_config(cfg)
    port = Model(pcfg, model_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg, "cpu"))
    return cfg, ref, params, port


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=1e-4,
                               rtol=1e-4, err_msg=what)


def whole_model_matches(arch, S, monkeypatch, n_dec=4):
    """forward logits and the router aux, prefill logits and caches, and
    ``n_dec`` teacher-forced decode steps with the caches after them."""
    cfg, ref, params, port = _carry(arch)
    # the reference's SWA prefill needs chunk + window <= S
    # (tests/test_torch_models.py::test_short_prompt_window_prefill)
    monkeypatch.setattr(ref_attn, "gqa_forward",
                        functools.partial(ref_attn.gqa_forward, chunk=32))
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S + n_dec)).astype(np.int32)
    want = ref.forward(params, {"tokens": jnp.asarray(toks[:, :S])})
    got = port.forward(torch.tensor(toks[:, :S], dtype=torch.int64))
    _close(got.detach(), want, "forward logits")
    _close(float(port.last_aux), float(ref._last_aux), "router aux")
    want, rcache = jax.jit(ref.prefill)(params,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    got, tcache = port.prefill(torch.tensor(toks[:, :S], dtype=torch.int64))
    assert got.shape == want.shape == (2, port.padded_vocab)
    _close(got, want, "prefill logits")
    for name in tcache:
        assert tuple(tcache[name].shape) == tuple(rcache[name].shape), name
        _close(tcache[name], rcache[name], f"prefill cache {name}")
    decode = jax.jit(ref.decode_step)
    for t in range(n_dec):
        tok = toks[:, S + t]
        want, rcache = decode(params, jnp.asarray(tok), rcache)
        got, tcache = port.decode_step(torch.tensor(tok, dtype=torch.int64),
                                       tcache)
        _close(got, want, f"decode step {t}")
    for name in tcache:
        _close(tcache[name], rcache[name], f"cache {name}")
    assert int(tcache["pos"]) == S + n_dec
    return port


@pytest.mark.parametrize("arch,S", [
    ("mixtral-8x7b", 96),           # window 64: C = 64, the ring wrapped
    ("deepseek-v2-lite-16b", 24),   # a dense first layer, MLA, shared
])
def test_whole_model_matches_reference(arch, S, monkeypatch):
    whole_model_matches(arch, S, monkeypatch)


@pytest.mark.parametrize("arch,S", [("mixtral-8x7b", 24),
                                    ("mixtral-8x7b", 96),
                                    ("deepseek-v2-lite-16b", 24)])
def test_decode_matches_forward(arch, S):
    """prefill + N decode steps == the full forward (teacher forcing) on
    the port alone, with drop-free capacity (cf = E), as
    tests/test_models.py holds the reference."""
    cfg = t_registry.get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
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


def test_blocks_follow_the_reference_layers():
    """deepseek: block 0 is the dense layer (first_dense_d_ff), the rest
    MoE with a shared expert; mixtral: every block MoE."""
    _, _, _, port = _carry("deepseek-v2-lite-16b")
    cfg = port.cfg
    assert "mlp" in port.blocks[0] and "moe" not in port.blocks[0]
    assert port.blocks[0]["mlp"]["w_up"].shape == (
        cfg.d_model, cfg.moe.first_dense_d_ff)
    assert all("moe" in bp and "shared" in bp["moe"]
               for bp in port.blocks[1:])
    assert len(port.blocks) == cfg.num_layers
    _, _, _, port = _carry("mixtral-8x7b")
    assert all("moe" in bp and "shared" not in bp["moe"]
               for bp in port.blocks)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "minicpm3-4b"])
def test_serve_main_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "80",
                      "--new-tokens", "4", "--seed", "0"])
    assert out["tokens"].shape == (2, 5)
    assert torch.isfinite(out["logits"]).all()
    text = capsys.readouterr().out
    assert "prefill 2x80" in text and "tok/s" in text
