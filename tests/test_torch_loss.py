"""``Model.loss`` and its gradients on the CPU, held against
``jax.value_and_grad(model.loss)`` of the JAX reference for every arch id
at its reduced size: the loss, its ``ce`` and ``router_aux`` parts, and
every gradient leaf, read through the port's flat view
(:mod:`repro_torch.models.flat`), whose order and values are also held
against the reference's ``ravel_pytree`` bitwise.  Plus the layer's
cross-entropy, and ``loss.backward()`` through a reduced zamba2 (the
Mamba2 block's in-place chunk transform broke autograd).

Tolerances: the loss rtol 1e-4; each gradient leaf atol 1e-5 x its
largest |g| plus rtol 1e-4 (f32 products summed in another order, through
a forward and a backward of several layers; the leaf's own scale sets the
absolute part, so a leaf whose gradient is small is held as tightly as a
large one); the cross-entropy atol = rtol = 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import registry as ref_registry
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as t_layers
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model
from test_torch_models import _to_port_config

ARCHS = [a for a in ref_registry.ARCH_IDS if a != "gfl-logreg"]
S = 40      # zamba2's chunk of 32 halves to 8: five chunks, the scan runs


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def carry(cfg, seed=1):
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    pcfg = _to_port_config(cfg)
    port = Model(pcfg, model_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg, "cpu"))
    return ref, params, port


def batch_for(cfg, B=2, seed=0, mask=False):
    """A reference batch (numpy) with the family's stub input."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        b["image_embeds"] = _np((B, cfg.num_image_tokens, cfg.d_model),
                                seed + 1, 0.1)
    if cfg.family == "audio":
        b["frames"] = _np((B, cfg.encoder_seq_len, cfg.d_model), seed + 1,
                          0.1)
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def to_port(batch):
    return {k: torch.tensor(v, dtype=torch.int64 if v.dtype == np.int32
                            else None) for k, v in batch.items()}


def _ref_value_and_grad(ref, params, batch):
    def f(p):
        loss, aux = ref.loss(p, batch, remat=False)
        return loss, aux
    (loss, aux), g = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return loss, aux, g


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match(arch, monkeypatch):
    monkeypatch.setattr(ref_attn, "gqa_forward",
                        functools.partial(ref_attn.gqa_forward, chunk=32))
    cfg = ref_registry.get_config(arch).reduced()
    ref, params, port = carry(cfg)
    batch = batch_for(cfg, mask=arch == "smollm-135m")
    loss, aux, g = _ref_value_and_grad(
        ref, params, jax.tree.map(jnp.asarray, batch))
    view = FlatView(port)
    w = view.ravel(port)
    tb = to_port(batch)
    got_aux = {}

    def loss_fn():
        val, a = port.loss(**tb)
        got_aux.update(a)
        return val
    grad = view.grad(port, w, loss_fn)
    np.testing.assert_allclose(float(loss_fn()), float(loss), rtol=1e-4)
    np.testing.assert_allclose(float(got_aux["ce"]), float(aux["ce"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got_aux["router_aux"]),
                               float(aux["router_aux"]), rtol=1e-4,
                               atol=1e-7)
    if cfg.moe is not None:
        assert float(aux["router_aux"]) > 0
    want = np.asarray(ravel_pytree(g)[0])
    assert want.shape == (view.size,)
    got = grad.numpy()
    for lf in view.leaves:
        n = lf.numel * len(lf.names)
        a, b = got[lf.offset:lf.offset + n], want[lf.offset:lf.offset + n]
        scale = float(np.abs(b).max())
        assert scale > 0, lf.path
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg="/".join(lf.path))


@pytest.mark.parametrize("arch", ARCHS + ["mixed-bf16"])
def test_ravel_is_ravel_pytree_bitwise(arch):
    """The flat view's order and values are ``ravel_pytree``'s, and its
    unravel reads every parameter back; a bf16 tree with f32 leaves
    (zamba2's A_log) promotes to f32 as ``ravel_pytree`` does."""
    if arch == "mixed-bf16":
        cfg = dataclasses.replace(
            ref_registry.get_config("zamba2-1.2b").reduced(),
            param_dtype="bfloat16")
    else:
        cfg = ref_registry.get_config(arch).reduced()
    ref, params, port = carry(cfg)
    flat0, _ = ravel_pytree(params)
    view = FlatView(port)
    w = view.ravel(port)
    assert str(w.dtype).replace("torch.", "") == str(flat0.dtype)
    want = np.asarray(flat0.astype(jnp.float32))
    assert np.array_equal(w.to(torch.float32).numpy(), want)
    back = view.unravel(w)
    for name, p in port.named_parameters():
        assert back[name].dtype == p.dtype and torch.equal(back[name], p), \
            name


def test_bind_reads_the_flat_vector_and_restores_the_module():
    cfg = _to_port_config(ref_registry.get_config("yi-6b").reduced())
    port = Model.init(cfg, torch.Generator().manual_seed(0))
    view = FlatView(port)
    w = view.ravel(port)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    before = port.forward(toks)
    with view.bind(port, 2 * w):
        doubled = port.forward(toks)
    assert not torch.equal(before, doubled)
    assert torch.equal(port.forward(toks), before)
    assert all(isinstance(p, torch.nn.Parameter)
               for p in port.parameters())


def test_mamba2_backward_runs_through_a_reduced_zamba2():
    """``loss.backward()`` through every Mamba2 layer: exp's saved output
    must not be overwritten by the chunk transform under autograd."""
    cfg = _to_port_config(ref_registry.get_config("zamba2-1.2b").reduced())
    port = Model.init(cfg, torch.Generator().manual_seed(0))
    for p in port.parameters():
        p.requires_grad_(True)
    tb = to_port(batch_for(cfg))
    loss, _ = port.loss(**tb)
    loss.backward()
    for name, p in port.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert float(port.blocks[0]["ssm"]["A_log"].grad.abs().max()) > 0
    # the prefill's in-place path, without grad, gives the same logits
    with torch.no_grad():
        want = port.forward(tb["tokens"])
    got = port.forward(tb["tokens"])
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(masked):
    logits = _np((2, 6, 40), 0, 3.0)
    labels = np.random.default_rng(1).integers(0, 40, (2, 6))
    mask = (np.random.default_rng(2).random((2, 6)) < 0.5).astype(
        np.float32) if masked else None
    want = ref_layers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = t_layers.cross_entropy(
        torch.tensor(logits), torch.tensor(labels),
        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


def test_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros((1, 3, 8))
    got = t_layers.cross_entropy(logits, torch.zeros((1, 3), dtype=torch.long),
                                 torch.zeros((1, 3)))
    assert float(got) == 0.0
