"""The federated LM (``repro_torch.launch.federated_lm``, the port of
``examples/federated_lm.py``) on the CPU, held against the JAX reference:
the flat init is the example's ``ravel_pytree(model.init(PRNGKey(0)))``
bit for bit; three GFL steps under none, iid_dp and hybrid from the
reference's own init and token batches, its draws replayed, match its
jitted step; kernels on against off under none; about twenty steps lower
the centroid's eval loss, as the example claims; the entry point.

Tolerance, after each step: atol 1e-5 (the reference's parity contract
for a round) on every parameter but the tied embedding table, and atol
4e-5 on the table.  Each client gradient is a forward and a backward of a
2-layer model, summed in another order by the two frameworks.  Outside
the table the largest difference over three seeds (0-2) and the three
mechanisms is 1.5e-6.  The table's rows of the most frequent tokens take
the largest updates, and their gradient (the softmax less the one-hot,
times the hidden states, summed over the tokens) cancels more as the
model learns the unigram, so their f32 difference grows with the steps:
at most 1.9e-6, 3.3e-6 and 1.5e-5 after steps 1-3 over the same nine runs
(the largest, seed 0 under none), which 4e-5 holds 2.6 times over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.base import GFLConfig as RefGFLConfig
from repro.configs import registry as ref_registry
from repro.core import gfl as ref_gfl
from repro.core.privacy.mechanism import mechanism_for as ref_mechanism_for
from repro.core.topology import combination_matrix
from repro.data import TokenStream as RefTokenStream
from repro.data import federated_token_batches as ref_batches
from repro.models import Model as RefModel
from repro_torch.configs import registry as t_registry
from repro_torch.convert import model_params_from_numpy
from repro_torch.core import gfl
from repro_torch.draws import ReplayDraws
from repro_torch.launch import federated_lm as flm
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model
from test_torch_models import _to_port_config
from test_torch_parity import round_draws

P, L, SEQ, PER_CLIENT = 2, 2, 16, 2


ATOL, ATOL_EMBED = 1e-5, 4e-5


def _ref_model(seed=0):
    cfg = ref_registry.get_config("smollm-135m").reduced()
    ref = RefModel(cfg)
    return cfg, ref, ref.init(jax.random.PRNGKey(seed))


def _port_model(cfg, params):
    pcfg = _to_port_config(cfg)
    return Model(pcfg, model_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg, "cpu"))


def test_flat_init_is_the_examples_ravel_pytree():
    cfg, _, params = _ref_model()
    flat0, _ = ravel_pytree(params)
    port = _port_model(cfg, params)
    w = FlatView(port).ravel(port)
    assert w.dtype == torch.float32 and w.shape == (flat0.size,)
    assert np.array_equal(w.numpy(), np.asarray(flat0))


def _ref_run(cfg, ref, params, gcfg, steps, seed=0):
    """The example's loop on the reference: its state, batches and jitted
    step (its key and the batches' seed ``seed``); returns the params
    after each step, the batches, and the draws of each round for
    ReplayDraws."""
    flat0, unravel = ravel_pytree(params)

    def grad_fn(w_flat, batch):
        return jax.grad(lambda w: ref.loss(unravel(w), batch,
                                           remat=False)[0])(w_flat)
    A = combination_matrix("ring", P)
    step = ref_gfl.make_gfl_step(A, grad_fn, gcfg)
    key = jax.random.PRNGKey(seed)
    state = ref_gfl.GFLState(jnp.broadcast_to(flat0, (P, flat0.size)),
                             jnp.zeros((), jnp.int32), key)
    stream = RefTokenStream(vocab=cfg.vocab_size, seed=0)
    mech = ref_mechanism_for(gcfg)
    out, batches, rounds = [], [], []
    state_key = key
    for i in range(steps):
        batch = ref_batches(stream, seed, i, P, L, PER_CLIENT, SEQ)
        state_key, sub = jax.random.split(state_key)
        key_round, key_combine = jax.random.split(sub)
        rounds.append(round_draws(mech, gcfg, key_round, key_combine, i, P,
                                  L, flat0.size, traced=True))
        state = step(state, batch)
        out.append(np.asarray(state.params))
        batches.append({k: torch.tensor(np.asarray(v), dtype=torch.int64)
                        for k, v in batch.items()})
    return out, batches, rounds


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("privacy", ["none", "iid_dp", "hybrid"])
def test_three_steps_match_the_reference(privacy, seed):
    cfg, ref, params = _ref_model(seed)
    kw = dict(num_servers=P, clients_per_server=L, privacy=privacy,
              sigma_g=0.01, mu=0.5, topology="ring", grad_bound=5.0)
    want, batches, rounds = _ref_run(cfg, ref, params, RefGFLConfig(**kw),
                                     3, seed)
    port = _port_model(cfg, params)
    view = FlatView(port)
    table, = [lf for lf in view.leaves if lf.path == ("embed", "table")]
    tol = np.full(view.size, ATOL, np.float32)
    tol[table.offset:table.offset + table.numel] = ATOL_EMBED
    gcfg = flm.gfl_config(P, L, privacy, 0.01)
    step = gfl.make_gfl_step(combination_matrix("ring", P),
                             flm.make_grad_fn(port, view), gcfg)
    state = gfl.GFLState(view.ravel(port).expand(P, -1).clone(), 0)
    draws = ReplayDraws(rounds, device="cpu")
    for i in range(3):
        state = step(state, batches[i], draws)
        err = np.abs(state.params.numpy() - want[i])
        assert (err <= tol).all(), (i, float(err.max()),
                                    float((err / tol).max()))
    assert draws.remaining == 0
    moved = np.abs(want[-1] - want[0]).max()
    assert moved > 1e-3          # the steps move the params


def test_kernels_on_matches_off_under_none():
    """The fused fold (K1 + K2's plain versions here) and K3's against the
    plain chain, one step from one state and batch."""
    cfg = t_registry.get_config("smollm-135m").reduced()
    outs = []
    for use in (False, True):
        tr = flm.Trainer.build(cfg, flm.gfl_config(P, L, "none", 0.01, use),
                               seq=SEQ, device="cpu")
        state = tr.step_fn()(tr.init_state(), tr.batch(0),
                             ReplayDraws([[]], device="cpu"))
        outs.append(state.params)
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=0)


def test_twenty_steps_lower_the_eval_loss():
    lines = []
    out = flm.run(t_registry.get_config("smollm-135m").reduced(), steps=20,
                  seq=32, device="cpu", log=lines.append)
    hist = out["history"]
    assert [h["step"] for h in hist] == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18,
                                         19]
    loss = [h["loss"] for h in hist]
    assert np.isfinite(loss).all() and loss[-1] < loss[0] - 0.5, loss
    eps = [h["eps"] for h in hist]
    assert all(b > a for a, b in zip(eps, eps[1:]))
    assert out["D"] == 1_312_000 and out["spectral_gap"] == pytest.approx(
        1 / 3, abs=1e-12)
    assert lines[0].startswith("model: smollm-135m-smoke  (1,312,000 params)")
    assert "centroid eval loss" in lines[2]


def test_entry_point_runs(capsys):
    out = flm.main(["--device", "cpu", "--steps", "2", "--servers", "2",
                    "--seq", "8", "--privacy", "iid_dp"])
    text = capsys.readouterr().out
    assert "ring graph spectral gap" in text and "eps(i)=" in text
    assert out["state"].params.shape == (2, out["D"])
    assert out["state"].step == 2


def test_flat_grad_is_each_client_gradient():
    """grad_fn's rows against each client's autograd gradient taken on the
    module's own parameters."""
    cfg = _to_port_config(ref_registry.get_config("yi-6b").reduced())
    port = Model.init(cfg, torch.Generator().manual_seed(0))
    view = FlatView(port)
    w = view.ravel(port)
    toks = torch.randint(0, cfg.vocab_size, (1, 2, 2, 9),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    got = flm.make_grad_fn(port, view)(w[None], batch)
    for p in port.parameters():
        p.requires_grad_(True)
    for l in range(2):
        port.zero_grad()
        port.loss(batch["tokens"][0, l], batch["labels"][0, l])[0].backward()
        want = torch.cat([dict(port.named_parameters())[n].grad.reshape(-1)
                          for lf in view.leaves for n in lf.names])
        torch.testing.assert_close(got[0, l], want, atol=1e-6, rtol=1e-5)
