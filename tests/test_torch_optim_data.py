"""The training substrate on the CPU, held against the JAX reference: the
token stream (the successor table, and the tokens composed from the
reference's own categorical and bernoulli draws, bit for bit), the
federated batches (disjoint clients, the ``client_ids`` identity), the
Section-V generator's shapes and moments; the optimizers (sgd, momentum
with and without Nesterov, adam, adamw) step by step, both clips and the
schedules, ``make_optimizer``'s dispatch, and ``TrainConfig``.

Tolerance: the optimizers, clips and schedules atol 1e-6 (the same f32
arithmetic; over 8 steps of Adam the bias corrections are powers taken in
f32 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import base as ref_base
from repro.data import synthetic as ref_syn
from repro_torch import optim as t_optim
from repro_torch.configs import base as t_base
from repro_torch.data import synthetic as t_syn

TOL = dict(atol=1e-6, rtol=0)


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("vocab,seed", [(512, 0), (49152, 0), (97, 3)])
def test_successor_table_is_the_references(vocab, seed):
    want = np.asarray(ref_syn.TokenStream(vocab, seed)._succ_table())
    got = t_syn.TokenStream(vocab, seed).succ_table().numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
def test_tokens_from_the_references_draws_are_bitwise(seed):
    """``compose_tokens`` fed the reference's k1 / k2 draws gives the
    reference's tokens exactly."""
    vocab, B, S = 512, 3, 33
    stream = ref_syn.TokenStream(vocab, seed=1)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(stream.sample(key, B, S))
    k1, k2, _ = jax.random.split(key, 3)
    logits = -jnp.log(jnp.arange(1, vocab + 1, dtype=jnp.float32))
    draws = np.asarray(jax.random.categorical(k1, logits, shape=(B, S)))
    use = np.asarray(jax.random.bernoulli(k2, stream.bigram_frac, (B, S)))
    got = t_syn.compose_tokens(torch.tensor(draws, dtype=torch.int64),
                               torch.tensor(use),
                               t_syn.TokenStream(vocab, seed=1).succ_table())
    assert np.array_equal(got.numpy(), want)
    assert use[:, 1:].any() and not use[:, 1:].all()


def test_sample_follows_the_zipf_unigram_and_the_successors():
    vocab = 64
    stream = t_syn.TokenStream(vocab, seed=2, bigram_frac=0.5)
    toks = stream.sample(torch.Generator().manual_seed(0), 4000, 6)
    assert toks.dtype == torch.int64 and toks.min() >= 0 and \
        toks.max() < vocab
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    first = np.bincount(toks[:, 0].numpy(), minlength=vocab) / 4000
    # rank 0's share within 5 standard errors
    assert abs(first[0] - p[0]) < 5 * np.sqrt(p[0] * (1 - p[0]) / 4000)
    succ = stream.succ_table()
    follows = (toks[:, 1:] == succ[toks[:, :-1]]).float().mean()
    # half the positions are bigrams, and a draw is a successor by chance
    assert 0.45 < float(follows) < 0.6


def test_federated_batches_are_disjoint_and_keep_client_ids():
    stream = t_syn.TokenStream(512, seed=0)
    b = t_syn.federated_token_batches(stream, 0, 3, 2, 3, 2, 16)
    assert b["tokens"].shape == b["labels"].shape == (2, 3, 2, 16)
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    flat = b["tokens"].reshape(6, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(6) for j in range(i))
    again = t_syn.federated_token_batches(stream, 0, 3, 2, 3, 2, 16)
    assert torch.equal(again["tokens"], b["tokens"])
    ids = np.array([[2, 0, 1], [1, 2, 0]])
    perm = t_syn.federated_token_batches(stream, 0, 3, 2, 3, 2, 16,
                                         client_ids=ids)
    for p in range(2):
        for l in range(3):
            assert torch.equal(perm["tokens"][p, l],
                               b["tokens"][p, ids[p, l]])
    other = t_syn.federated_token_batches(stream, 0, 4, 2, 3, 2, 16)
    assert not torch.equal(other["tokens"], b["tokens"])


def test_logistic_client_data_shapes_and_moments():
    feats, labels = t_syn.logistic_client_data(
        torch.Generator().manual_seed(0), 3, 4, 500, 2)
    want = jax.eval_shape(lambda k: ref_syn.logistic_client_data(
        k, 3, 4, 500, 2), jax.random.PRNGKey(0))
    assert feats.shape == want[0].shape and labels.shape == want[1].shape
    assert set(labels.unique().tolist()) == {-1.0, 1.0}
    resid = feats - labels[..., None]
    sd = resid.std(dim=(2, 3))
    assert float(sd.min()) > 0.4 and float(sd.max()) < 1.6


# ------------------------------------------------------------------- optim


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(5)).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.tensor, tree)


def _same(got, want):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **TOL), got, want)


OPTS = [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
        ("adam", {}), ("adamw", {}), ("adam", {"weight_decay": 0.1})]


@pytest.mark.parametrize("name,kw", OPTS, ids=lambda v: str(v))
def test_optimizer_matches_step_by_step(name, kw):
    ref = getattr(ref_optim, name)(**kw)
    port = getattr(t_optim, name)(**kw)
    params = _tree(0)
    rp, tp = _j(params), _t(params)
    rs, ts = ref.init(rp), port.init(tp)
    for step in range(8):
        g = _tree(10 + step, 0.5)
        lr = 0.05
        rupd, rs = ref.update(_j(g), rs, rp, jnp.int32(step), lr)
        tupd, ts = port.update(_t(g), ts, tp, step, lr)
        _same(tupd, rupd)
        rp = jax.tree.map(lambda p, u: p + u, rp, rupd)
        tp = t_optim.tree_map(lambda p, u: p + u, tp, tupd)
    _same(tp, rp)
    if name != "sgd":
        _same(ts, rs)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clips_match(max_norm):
    tree = _tree(3, 2.0)
    want, wn = ref_optim.clip_by_global_norm(_j(tree), max_norm)
    got, gn = t_optim.clip_by_global_norm(_t(tree), max_norm)
    _same(got, want)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    _same(t_optim.per_leaf_clip(_t(tree), max_norm),
          ref_optim.per_leaf_clip(_j(tree), max_norm))


@pytest.mark.parametrize("sched,args", [
    ("constant", (0.3,)), ("cosine_decay", (0.3, 50)),
    ("cosine_decay", (0.3, 50, 0.0)), ("warmup_cosine", (0.3, 10, 60)),
    ("warmup_cosine", (1.0, 0, 20, 0.2))], ids=str)
def test_schedules_match(sched, args):
    ref = getattr(ref_optim, sched)(*args)
    port = getattr(t_optim, sched)(*args)
    for step in [0, 1, 5, 9, 10, 11, 30, 59, 60, 75]:
        np.testing.assert_allclose(float(port(step)),
                                   float(ref(jnp.int32(step))), **TOL)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam", "adamw"])
def test_make_optimizer_dispatches(opt):
    cfg = t_base.TrainConfig(optimizer=opt, beta1=0.8, weight_decay=0.05)
    ref = ref_optim.make_optimizer(ref_base.TrainConfig(
        optimizer=opt, beta1=0.8, weight_decay=0.05))
    port = t_optim.make_optimizer(cfg)
    params, g = _tree(0), _tree(1)
    rs, ts = ref.init(_j(params)), port.init(_t(params))
    for step in range(3):
        rupd, rs = ref.update(_j(g), rs, _j(params), jnp.int32(step), 0.1)
        tupd, ts = port.update(_t(g), ts, _t(params), step, 0.1)
    _same(tupd, rupd)


def test_make_optimizer_rejects_lion():
    with pytest.raises(ValueError, match="lion"):
        t_optim.make_optimizer(t_base.TrainConfig(optimizer="lion"))


def test_train_config_fields_and_defaults_match():
    def spec(cls):
        return [(f.name, f.default, str(f.type))
                for f in dataclasses.fields(cls)]
    assert spec(t_base.TrainConfig) == spec(ref_base.TrainConfig)
