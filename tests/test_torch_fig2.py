"""The paper's Fig. 2 experiment in the port against ``repro``, on the CPU.

The statistical check the port's plan asks for: Generator-seeded runs
cannot reproduce the reference's threefry draws, so each scheme's MSD tail
is held to the reference's in distribution.  Both packages run the same
problem (the reference's, converted) at P=4, K=10, L=5, 100 rounds, eight
repeats each (seeds 1000..1007, as ``run_schemes`` numbers them); a
repeat's tail is its mean MSD over the last 10 rounds.  The mean log tails
must agree within ``SES`` = 4 standard errors of their difference
(sqrt(s_port^2 / 8 + s_ref^2 / 8)): for normal log tails a false alarm at
under 1e-4.  Seeds are fixed, so the test is deterministic.

Other tolerances: ``global_risk`` rtol 1e-6; the hybrid family's centroid
after one round at sigma 0.5 within atol 1e-5 of the sigma-0 centroid, and
iid_dp's at least 1e-3 away; ``privacy_epsilon``'s rows exactly equal.
"""
import csv
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GFLConfig as RefConfig
from repro.core import gfl as ref_gfl
from repro.core.population import DensePopulation as RefDense
from repro.core.population.engine import uniform_cohort_batch as ref_cohort
from repro.core.privacy.accountant import epsilon_at
from repro.core.simulate import generate_problem as ref_generate
from repro.core.simulate import global_risk as ref_global_risk
from repro.core.simulate import make_grad_fn as ref_grad_fn
from repro.core.simulate import run_gfl as ref_run_gfl
from repro.core.topology import combination_matrix
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import problem_from_numpy
from repro_torch.core import gfl
from repro_torch.core.simulate import (
    global_risk,
    make_grad_fn,
    run_gfl,
    run_schemes,
)
from repro_torch.draws import Draws

ROOT = Path(__file__).resolve().parents[1]
SCHEMES = ["none", "iid_dp", "hybrid", "gaussian_dp", "scheduled"]
P, K, L, ITERS, REPEATS, SES = 4, 10, 5, 100, 8, 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs here are many small ops, which torch's
    thread pool slows by orders of magnitude when the test run's other
    processes hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_problem():
    return ref_generate(jax.random.PRNGKey(0), P=P, K=K)


@pytest.fixture(scope="module")
def problem(ref_problem):
    return problem_from_numpy(ref_problem.features, ref_problem.labels,
                              ref_problem.rho, ref_problem.w_opt,
                              device="cpu")


def _kw(scheme, sigma, **kw):
    """The config ``run_schemes`` builds, at the test's size."""
    base = dict(num_servers=P, clients_per_server=K, clients_sampled=L,
                topology="full", privacy=scheme, sigma_g=sigma, mu=0.1,
                grad_bound=10.0, epsilon_target=epsilon_at(ITERS, 0.1, 10.0,
                                                            sigma),
                epsilon_horizon=ITERS)
    base.update(kw)
    return base


def _tail(msd):
    return float(np.mean(np.asarray(msd)[-max(ITERS // 10, 5):]))


def _ref_msd_runs(ref_problem, rcfg, seeds, batch_size=10):
    """The reference's pure-path loop (``_run_pure_loop``: one cohort key and
    one jitted ``make_gfl_step`` step a round), compiled once for every
    seed instead of once a run."""
    step = ref_gfl.make_gfl_step(
        jnp.asarray(combination_matrix(rcfg.topology, P)),
        ref_grad_fn(ref_problem.rho), rcfg)
    pop = RefDense.from_problem(ref_problem)
    sample = jax.jit(lambda k: ref_cohort(k, pop, L, batch_size))
    out = []
    for seed in seeds:
        key, k_init = jax.random.split(jax.random.PRNGKey(seed))
        state = ref_gfl.init_state(k_init, P, 2)
        msd = []
        for _ in range(ITERS):
            key, kb = jax.random.split(key)
            state = step(state, sample(kb))
            msd.append(float(jnp.sum((ref_gfl.centroid(state.params)
                                      - ref_problem.w_opt) ** 2)))
        out.append(np.asarray(msd))
    return out


def test_reference_loop_is_run_gfl(ref_problem):
    """The loop above is the reference's run_gfl, bit for bit."""
    rcfg = RefConfig(**_kw("hybrid", 1.0))
    want, _ = ref_run_gfl(ref_problem, rcfg, iters=ITERS, batch_size=10,
                          seed=1000)
    [got] = _ref_msd_runs(ref_problem, rcfg, [1000])
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("sigma", [0.2, 1.0])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tails_match_reference_statistically(scheme, sigma, ref_problem,
                                             problem):
    seeds = [1000 + r for r in range(REPEATS)]
    ref = np.log([_tail(m) for m in _ref_msd_runs(
        ref_problem, RefConfig(**_kw(scheme, sigma)), seeds)])
    cfg = GFLConfig(**_kw(scheme, sigma))
    port = np.log([_tail(run_gfl(problem, cfg, iters=ITERS, batch_size=10,
                                 seed=s)[0]) for s in seeds])
    se = np.sqrt(port.var(ddof=1) / REPEATS + ref.var(ddof=1) / REPEATS)
    diff = abs(port.mean() - ref.mean())
    assert np.all(np.isfinite(port))
    assert diff <= SES * se, (scheme, sigma, port.mean(), ref.mean(), se)


@pytest.mark.parametrize("scheme,noise_free", [
    ("hybrid", True), ("gaussian_dp", True), ("scheduled", True),
    ("iid_dp", False)])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_centroid_identity(scheme, noise_free, use_kernels, problem):
    """The hybrid family's noise cancels in the network centroid (pair
    masks in the client mean, eq. 25's nullspace noise in the combine);
    iid_dp's does not."""
    gen = torch.Generator().manual_seed(4)
    params = torch.randn((P, 2), generator=gen)
    h = torch.randn((P, L, 6, 2), generator=gen)
    gam = torch.where(torch.rand((P, L, 6), generator=gen) < 0.5, 1.0, -1.0)
    A = combination_matrix("ring", P)

    def centroid(sigma):
        cfg = GFLConfig(**_kw(scheme, sigma, topology="ring",
                              use_kernels=use_kernels,
                              epsilon_target=epsilon_at(ITERS, 0.1, 10.0, 0.5)
                              if sigma else 0.0))
        out = gfl.gfl_round(params, (h, gam), Draws(3, "cpu"), A=A,
                            grad_fn=make_grad_fn(0.01), cfg=cfg, step=0)
        return gfl.centroid(out)

    clean, noisy = centroid(0.0), centroid(0.5)
    if noise_free:
        np.testing.assert_allclose(noisy.numpy(), clean.numpy(), atol=1e-5)
    else:
        assert (noisy - clean).abs().max() > 1e-3


def test_global_risk_matches_reference(ref_problem, problem):
    rng = np.random.default_rng(2)
    for _ in range(3):
        w = rng.standard_normal(2).astype(np.float32)
        want = float(ref_global_risk(jnp.asarray(w), ref_problem))
        got = float(global_risk(torch.tensor(w), problem))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    got = float(global_risk(problem.w_opt, problem))
    assert got <= float(global_risk(problem.w_opt + 0.05, problem))


def test_fig2_problem_file_is_the_reference_problem():
    """data/fig2_problem0.npz, on which the card's fig2 phase runs, is the
    reference's problem of key 0 (its Fig. 2 benchmark's), exactly."""
    from repro_torch.launch.fig2_convergence import load_problem

    ref = ref_generate(jax.random.PRNGKey(0), P=10, K=50)
    prob = load_problem(ROOT / "data" / "fig2_problem0.npz", "cpu")
    for name in ("features", "labels", "w_opt"):
        assert np.array_equal(getattr(prob, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert prob.rho == pytest.approx(ref.rho, rel=1e-7)


def test_run_schemes_takes_a_problem():
    kw = dict(iters=6, repeats=1, batch_size=5, schemes=("hybrid",),
              device="cpu")
    prob, drawn = run_schemes(0, P=3, K=4, **kw)
    given, again = run_schemes(5, P=7, K=9, problem=prob, **kw)
    assert given is prob
    assert drawn["hybrid"].tolist() == again["hybrid"].tolist()


def test_run_schemes_carries_the_fault():
    kw = dict(iters=6, P=3, K=4, repeats=1, batch_size=5,
              schemes=("hybrid", "iid_dp"), device="cpu")
    _, static = run_schemes(0, **kw)
    _, null = run_schemes(0, fault="links:0.0", **kw)
    _, hit = run_schemes(0, fault="outage:0.6", topology_seed=2, **kw)
    for scheme in kw["schemes"]:
        assert static[scheme].tolist() == null[scheme].tolist()
        assert static[scheme].tolist() != hit[scheme].tolist()


# -------------------------------------------------------- entry points ----


def _run_entry(name, args, capsys):
    mod = importlib.import_module(f"repro_torch.launch.{name}")
    mod.main(["--reduced", "--device", "cpu"] + args)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    return mod, out[1:]


def test_fig2_entry_prints_the_reference_rows(capsys):
    _, out = _run_entry("fig2_convergence", [], capsys)
    assert out[0] == "sigma_g,scheme,iter,msd"
    summary = [ln.split(",") for ln in out if ln.startswith("fig2_msd")]
    trace = [ln.split(",") for ln in out[1:len(out) - len(summary)]]
    names = [f"fig2_msd_tail/sigma={s}/{m}" for s in (0.2, 1.0)
             for m in sorted(SCHEMES)]
    assert [n for n, _ in summary] == names
    assert all(np.isfinite(float(v)) for _, v in summary)
    # every 10th of the 120 iterations, and the last
    assert len(trace) == 2 * len(SCHEMES) * 13
    tails = {n: float(v) for n, v in summary}
    assert (tails["fig2_msd_tail/sigma=1.0/hybrid"]
            < tails["fig2_msd_tail/sigma=1.0/iid_dp"])


def test_fig2_entry_reads_a_problem_file(capsys, tmp_path):
    from repro_torch.launch import fig2_convergence

    ref = ref_generate(jax.random.PRNGKey(3), P=10, K=50)
    path = tmp_path / "problem.npz"
    np.savez(path, features=np.asarray(ref.features),
             labels=np.asarray(ref.labels), rho=np.float32(ref.rho),
             w_opt=np.asarray(ref.w_opt))
    fig2_convergence.main(["--device", "cpu", "--iters", "6", "--repeats",
                           "1", "--problem", str(path)])
    out = capsys.readouterr().out.splitlines()
    printed = [ln.split(",") for ln in out if ln.startswith("fig2_msd")]
    _, summary = fig2_convergence.run(
        6, 1, device="cpu",
        problem=fig2_convergence.load_problem(path, "cpu"))
    assert [n for n, _ in printed] == [n for n, _ in summary]
    assert [float(v) for _, v in printed] == pytest.approx(
        [v for _, v in summary], rel=1e-5)


def test_noise_sweep_entry_prints_the_reference_rows(capsys):
    _, out = _run_entry("noise_sweep", [], capsys)
    rows = list(csv.reader(out[:-2]))
    assert rows[0] == ["scheme", "sigma_g", "msd_tail"]
    assert len(rows) == 1 + 1 + 4 * 5
    assert [ln.split(",")[0] for ln in out[-2:]] == [
        "noise_sweep/hybrid_over_none@sigma2",
        "noise_sweep/iid_over_none@sigma2"]
    assert all(np.isfinite(float(r[2])) for r in rows[1:])


def test_privacy_epsilon_rows_equal_the_reference(capsys, monkeypatch,
                                                  tmp_path):
    _, out = _run_entry("privacy_epsilon", [], capsys)
    spec = importlib.util.spec_from_file_location(
        "ref_privacy_epsilon", ROOT / "benchmarks" / "privacy_epsilon.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(ref, "OUT", str(tmp_path))
    ref_summary = ref.run()
    with open(tmp_path / "privacy_epsilon.csv") as f:
        ref_rows = list(csv.reader(f))
    assert list(csv.reader(out[:len(ref_rows)])) == ref_rows
    assert [ln.split(",") for ln in out[len(ref_rows):]] == [
        [n, repr(v)] for n, v in ref_summary]


def test_dp_sweep_entry_prints_its_rows(capsys):
    mod, out = _run_entry("dp_sweep", [], capsys)
    rows = list(csv.reader(out[:-1]))
    assert rows[0] == ["eps_target", "scheme", "sigma_g", "msd_tail"]
    assert [r[1] for r in rows[1:]] == list(mod.SCHEMES)
    assert all(np.isfinite(float(r[3])) for r in rows[1:])
    assert out[-1].startswith("# scheduled:gaussian_dp profile: "
                              "curve=scheduled distribution=gaussian")


def test_entries_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("fig2_convergence", "noise_sweep", "privacy_epsilon",
                 "dp_sweep", "fault_sweep", "resilience_demo"):
        mod = importlib.import_module(f"repro_torch.launch.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--reduced"])

