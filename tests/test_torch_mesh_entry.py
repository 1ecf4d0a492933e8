"""The mesh's entry points and pieces on the CPU: ``launch.train`` with
faults, a virtual population, the event layer, telemetry and the
consensus checkpoint (which the reference's loader reads);
``launch.private_serving``; ``remat`` on the gradients of every family
(bitwise); the step's guards; the per-leaf K3 combine against the einsum
(the case of ``tests/test_round_fold.py:308``, against the reference's
too); ``Mesh.ppermute`` on one rank; sparse against dense on the (3, 2, 1)
pod mesh (``tests/test_resilience.py:388``); all-ones cohort weights
within 1e-6 of none (``tests/test_population.py:432``); the mechanisms'
tree noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.configs.registry import get_config as ref_get_config
from repro.core.topology import combination_matrix as ref_combination_matrix
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro_torch import rng
from repro_torch.configs.base import GFLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.privacy.mechanism import mechanism_for
from repro_torch.core.topology import combination_matrix
from repro_torch.data.synthetic import TokenStream, federated_token_batches
from repro_torch.draws import Draws, DrawKey
from repro_torch.launch import private_serving, serve, train
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh, mesh_from_arg,
                                     parse_mesh)
from repro_torch.models.flat import FlatView
from repro_torch.models.model import Model
from repro_torch.telemetry import session

torch.set_num_threads(1)


def _smollm():
    cfg = get_config("smollm-135m").reduced()
    return cfg, Model.init(cfg, rng(0, "cpu"))


def _batch(cfg, P, step=0, seq=16):
    return federated_token_batches(TokenStream(vocab=cfg.vocab_size, seed=0),
                                   0, step, P, 2, 2, seq)


# ------------------------------------------------------------ entries


def test_train_entry_with_everything(tmp_path):
    ckpt = tmp_path / "ckpt"
    with session("memory") as sess:
        out = train.main([
            "--arch", "smollm-135m", "--reduced", "--mesh", "2x1",
            "--steps", "2", "--seq", "16", "--device", "cpu",
            "--fault", "links:0.2+dropout:0.3", "--virtual-clients", "50",
            "--async", "async:buffer=2,latency=lognorm:0.5,max_stale=4",
            "--telemetry", "memory", "--checkpoint", str(ckpt),
            "--combine", "rotate"])
        mesh_recs = sess.memory_records("mesh")
        step_recs = sess.memory_records("step")
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert [r["step"] for r in mesh_recs] == [0, 1]
    assert all("gap" in r for r in mesh_recs)
    assert [r["step"] for r in step_recs] == [1, 2]
    params = out["state"].params
    assert all(torch.isfinite(v).all() for v in params.values())
    # the reference's loader reads the consensus checkpoint (server 0)
    ref = RefModel(ref_get_config("smollm-135m").reduced())
    like = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    tree, step = ref_load_checkpoint(str(ckpt), like)
    assert int(step) == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        assert np.array_equal(np.asarray(leaf), params[key][0].numpy()), key


def test_train_entry_refusals():
    base = ["--arch", "smollm-135m", "--reduced", "--steps", "1",
            "--device", "cpu", "--seq", "16"]
    with pytest.raises(NotImplementedError, match="20c"):
        train.main(base + ["--mesh", "2x2"])
    with pytest.raises(SystemExit):
        train.main(base + ["--mesh", "2x1", "--cohort", "uniform+trace:"
                           "diurnal,period=24,min=0.2"])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "llava-next-mistral-7b",
                                  "whisper-tiny"])
def test_private_serving_runs(arch, capsys):
    out = private_serving.main(["--arch", arch, "--device", "cpu",
                                "--batch", "2", "--prompt-len", "16",
                                "--new-tokens", "4"])
    assert out["tokens"].shape == (2, 5)
    assert "OK" in capsys.readouterr().out


def test_serve_mesh_refuses_a_model_axis():
    with pytest.raises(NotImplementedError, match="20c"):
        serve.main(["--reduced", "--device", "cpu", "--mesh", "1x2"])


def test_serve_steps_read_a_param_tree():
    """``make_prefill_step`` / ``make_decode_step`` run a model on the
    tree they are given (another model's weights here), as the
    reference's steps take their params."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    model = Model.init(cfg, rng(0, "cpu"))
    other = Model.init(cfg, rng(1, "cpu"))
    tree = FlatView(model).tree(model)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(3))
    prefill, decode = (steps.make_prefill_step(other),
                       steps.make_decode_step(other))
    got, cache = prefill(tree, {"tokens": tok})
    want, want_cache = model.prefill(tok)
    assert torch.equal(got, want)
    got, _ = decode(tree, got.argmax(-1), cache)
    want, _ = model.decode_step(want.argmax(-1), want_cache)
    assert torch.equal(got, want)
    own, _ = prefill(None, {"tokens": tok})
    assert torch.equal(own, other.prefill(tok)[0])


# -------------------------------------------------------------- remat


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b",
                                  "zamba2-1.2b", "rwkv6-3b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_remat_gradients_are_bitwise_off(arch):
    cfg = get_config(arch).reduced()
    model = Model.init(cfg, rng(0, "cpu"))
    view = FlatView(model)
    tree = view.tree(model)
    gen = torch.Generator().manual_seed(1)
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    batch.update(serve.stub_inputs(cfg, B, gen))
    outs = [view.tree_grad(model, tree, lambda: model.loss(
        **batch, remat=remat, remat_policy=pol)[0])
        for remat, pol in ((False, None), (True, None), (True, "dots"),
                           (True, "nothing"))]
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        assert all(torch.equal(grads[k], outs[0][1][k]) for k in grads)
    with pytest.raises(ValueError, match="remat policy"):
        model.loss(**batch, remat_policy="everything")


# ------------------------------------------------------------- guards


def test_train_step_guards():
    """The reference's refusals (``tests/test_resilience.py:373``) and the
    port's own: a model axis without client_parallel, a world that does
    not fit the mesh."""
    cfg, model = _smollm()
    mesh = make_test_mesh((1, 1), device="cpu")
    with pytest.raises(ValueError, match="straggler"):
        steps.make_train_step(model, GFLConfig(fault="straggler:0.2"), mesh)
    pods = make_test_mesh((3, 2, 1), ("pod", "data", "model"), device="cpu")
    with pytest.raises(ValueError, match="multi-pod"):
        steps.make_train_step(model, GFLConfig(fault="links:0.1",
                                               combine_impl="sparse"), pods)
    steps.make_train_step(model, GFLConfig(fault="links:0.1",
                                           combine_impl="rotate"), pods)
    with pytest.raises(NotImplementedError, match="item 20c"):
        steps.make_train_step(model, GFLConfig(),
                              make_test_mesh((2, 2), device="cpu"))
    steps.make_train_step(model, GFLConfig(client_parallel=True),
                          make_test_mesh((2, 2), device="cpu"))
    with pytest.raises(ValueError, match="cannot hold"):
        Mesh((3, 1), ("data", "model"), world=2, rank=0).layout()
    with pytest.raises(ValueError, match="cannot hold"):
        Mesh((4, 2), ("data", "model"), world=3, rank=0).layout()


@pytest.mark.parametrize("make", [
    lambda: make_test_mesh((4, 1)), lambda: make_production_mesh(),
    lambda: parse_mesh("2x1"), lambda: mesh_from_arg("production")],
    ids=["test_mesh", "production_mesh", "parse_mesh", "mesh_from_arg"])
def test_mesh_device_defaults_to_cuda(make):
    """A mesh built without a device never picks the CPU: it is the card,
    or it raises when there is none; a spec-only mesh needs no card."""
    mesh = make()
    assert "cuda" in repr(mesh)
    if torch.cuda.is_available():
        assert mesh.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            steps.make_train_step(_smollm()[1], GFLConfig(), mesh)
    assert make_test_mesh((4, 1), device="cpu").device == torch.device("cpu")


# ----------------------------------------------- the per-leaf K3 combine


def test_kernel_dense_combine_matches_einsum():
    """The case of ``tests/test_round_fold.py:308``: bf16 and f32 leaves,
    with g and without, the kernel path (K3's plain version here) against
    the einsum at 2e-2 (bf16) and 1e-5 (f32), and both against the
    reference's."""
    P = 6
    A = jnp.asarray(ref_combination_matrix("ring", P), jnp.float32)
    k = jax.random.PRNGKey(0)
    psi = {"a": jax.random.normal(k, (P, 3, 7)).astype(jnp.bfloat16),
           "b": jax.random.normal(jax.random.fold_in(k, 1), (P, 11))}
    g = {"a": (jax.random.normal(jax.random.fold_in(k, 2), (P, 3, 7)) * 0.3
               ).astype(jnp.bfloat16),
         "b": jax.random.normal(jax.random.fold_in(k, 3), (P, 11)) * 0.3}

    def port(tree):
        return {n: torch.from_numpy(np.array(v, np.float32)).to(
            torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
            for n, v in tree.items()}

    At = torch.as_tensor(combination_matrix("ring", P), dtype=torch.float32)
    for noise in (g, None):
        want = steps._dense_combine(At, port(psi),
                                    None if noise is None else port(noise))
        got = steps._kernel_dense_combine(
            At, port(psi), None if noise is None else port(noise))
        ref = ref_steps._dense_combine(A, psi, noise, cancel=True)
        ref_k = ref_steps._kernel_dense_combine(A, psi, noise)
        for leaf in psi:
            bf = psi[leaf].dtype == jnp.bfloat16
            tol = 2e-2 if bf else 1e-5
            assert got[leaf].dtype == want[leaf].dtype
            assert (got[leaf].float() - want[leaf].float()).abs().max() \
                <= tol
            for mine, theirs in ((want, ref), (got, ref_k)):
                # the f32 paths to float order; bf16 to one rounding
                ulp = 2.0 ** -7 * float(np.abs(np.asarray(
                    theirs[leaf], np.float32)).max()) if bf else 1e-6
                assert np.abs(mine[leaf].float().numpy() - np.asarray(
                    theirs[leaf], np.float32)).max() <= ulp, leaf


# ----------------------------------------------------------- ppermute


def test_ppermute_on_one_rank():
    mesh = make_test_mesh((4, 1), device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    ring = [((i + 1) % 4, i) for i in range(4)]
    assert torch.equal(mesh.ppermute(x, ring), x[[1, 2, 3, 0]])
    part = mesh.ppermute(x, [(0, 2), (3, 1)])
    assert torch.equal(part, torch.stack([torch.zeros(3), x[3], x[0],
                                          torch.zeros(3)]))
    assert mesh.local_servers == range(4)
    assert mesh.all_gather_servers(x) is x


# ------------------------------------------------------ combine checks


def _one_step(model, cfg, mesh, gcfg, P, **kw):
    step = steps.make_train_step(model, gcfg, mesh)
    state = steps.init_train_state(model, gcfg, mesh, 0)
    return step(state, _batch(cfg, P, seq=32), **kw)[0].params


def test_multipod_sparse_matches_dense():
    """The (3, 2, 1) product-graph sparse combine against the dense one on
    kron(A_pod, A_data), one step (``tests/test_resilience.py:388``)."""
    cfg, model = _smollm()
    mesh = make_test_mesh((3, 2, 1), ("pod", "data", "model"), device="cpu")
    outs = {impl: _one_step(model, cfg, mesh, GFLConfig(
        topology="ring", privacy="none", mu=0.05, grad_bound=10.0,
        combine_impl=impl), 6) for impl in ("dense", "sparse")}
    for k, v in outs["dense"].items():
        assert (v - outs["sparse"][k]).abs().max() <= 1e-5, k
    A = steps.make_combination_matrix(mesh, GFLConfig())
    assert np.array_equal(A, np.kron(combination_matrix("ring", 3),
                                     combination_matrix("ring", 2)))


def test_cohort_weights_all_ones_match_none():
    """``tests/test_population.py:432``'s check: all-ones cohort weights
    within 1e-6 of the unweighted step; spread weights move it."""
    cfg, model = _smollm()
    mesh = make_test_mesh((2, 1), device="cpu")
    gcfg = GFLConfig(topology="ring", privacy="none", mu=0.05,
                     grad_bound=10.0, combine_impl="dense")
    plain = _one_step(model, cfg, mesh, gcfg, 2)
    ones = _one_step(model, cfg, mesh, gcfg, 2,
                     cohort_weights=np.ones((2, 2), np.float32))
    spread = _one_step(model, cfg, mesh, gcfg, 2, cohort_weights=np.asarray(
        [[2.0, 0.5], [1.5, 1.0]], np.float32))
    t = "embed/table"
    assert (plain[t] - ones[t]).abs().max() <= 1e-6
    assert (plain[t] - spread[t]).abs().max() > 1e-7


def test_bf16_clip_matches_the_reference():
    """A bf16 gradient tree (the mesh step's at full width) clipped as jnp
    clips it: scaled in f32 by the f32 coefficient, rounded once."""
    from repro.optim.clip import clip_by_global_norm as ref_clip
    from repro_torch.optim.clip import clip_by_global_norm
    gen = torch.Generator().manual_seed(0)
    tree = {"a": (50 * torch.randn((64, 33), generator=gen)).to(
        torch.bfloat16), "b": torch.randn((7,), generator=gen)}
    got, gn = clip_by_global_norm(tree, 1.0)
    want, wn = ref_clip({"a": jnp.asarray(tree["a"].float().numpy()).astype(
        jnp.bfloat16), "b": jnp.asarray(tree["b"].numpy())}, 1.0)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    assert got["a"].dtype == torch.bfloat16
    # bf16: one rounding of the f32 product, so the norm's float order
    # (1e-7 relative) does not show; the f32 leaf shows it
    assert np.array_equal(got["a"].float().numpy(),
                          np.asarray(want["a"], np.float32))
    assert np.allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=1e-6,
                       atol=0)


# --------------------------------------------------------- tree noise


def test_tree_noise_api():
    """Each noise tree is one draw of its stream; iid_dp's client noise
    scales with each server's survivor count; the cancelling mechanisms
    draw no client noise; scheduled draws at its round's sigma."""
    tree = {"a": torch.empty((3, 4, 5), device="meta"),
            "b": torch.empty((3, 7), dtype=torch.bfloat16, device="meta")}
    key = DrawKey(Draws(0, "cpu"), 0)
    iid = mechanism_for(GFLConfig(privacy="iid_dp", sigma_g=0.5))
    L = torch.tensor([1.0, 4.0, 16.0])
    noise = iid.client_noise_tree(key, tree, L, None)
    assert noise["b"].dtype == torch.bfloat16 and noise["a"].shape == (3, 4, 5)
    with pytest.raises(RuntimeError, match="drew from"):
        iid.client_noise_tree(key, tree, L, None)
    again = iid.client_noise_tree(DrawKey(Draws(0, "cpu"), 0), tree, 2, None)
    u = Draws(0, "cpu").laplace_uniform_tree(0, "client", [(3, 4, 5),
                                                          (3, 7)])
    b = 0.5 / torch.sqrt(torch.tensor(2.0)) / torch.sqrt(L)
    want = -b[:, None, None] * torch.sign(u[0]) * torch.log1p(
        -2 * u[0].abs())
    assert torch.allclose(noise["a"], want, atol=1e-7)
    assert torch.allclose(again["a"] * np.sqrt(2), want * torch.sqrt(
        L)[:, None, None], atol=1e-6)
    for name in ("none", "hybrid", "gaussian_dp", "scheduled"):
        mech = mechanism_for(GFLConfig(privacy=name))
        assert mech.client_noise_tree(key, tree, 2, None) is None
    assert mechanism_for(GFLConfig(privacy="none")).combine_noise_tree(
        key, tree, None) is None
    sched = mechanism_for(GFLConfig(privacy="scheduled", sigma_g=0.5,
                                    epsilon_target=3000.0,
                                    epsilon_horizon=10))
    from repro_torch.core.privacy.mechanism import RoundContext
    g = sched.combine_noise_tree(DrawKey(Draws(0, "cpu"), 2), tree,
                                 RoundContext(step=2))
    u = Draws(0, "cpu").laplace_uniform_tree(2, "combine", [(3, 4, 5),
                                                           (3, 7)])
    s = sched.sigma_at(2)
    want = -(torch.tensor(s, dtype=torch.float32) / torch.sqrt(
        torch.tensor(2.0))) * torch.sign(u[0]) * torch.log1p(
        -2 * u[0].abs())
    assert torch.allclose(g["a"], want, atol=1e-7)
