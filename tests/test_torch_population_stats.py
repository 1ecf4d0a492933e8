"""The weighted path's statistics against the reference, and the
population entries, on the CPU.

Generator-seeded draws cannot reproduce the reference's threefry draws, so
each cohort's MSD tail is held to the reference's in distribution, as
``tests/test_torch_fig2.py`` holds the Fig. 2 tails.  Both packages run
the reference's own problem (``data/fig2_problem0.npz``: P=10, K=50,
N=100, M=2), hybrid at sigma 0.2 (its centroid is noise-free, so the tail
is the sampler's), L=10, full topology, mu 0.1, B 10, 150 rounds, eight
repeats each (seeds 1000..1007); a repeat's tail is its mean MSD over the
last 15 rounds.  The mean log tails must agree within ``SES`` = 4 standard
errors of their difference (sqrt(s_port^2 / 8 + s_ref^2 / 8)): for normal
log tails a false alarm at under 1e-4.  Seeds are fixed, so the test is
deterministic.
"""
import csv
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GFLConfig as RefConfig
from repro.core.population.engine import run_gfl_population as ref_run_pop
from repro.core.simulate import LogisticProblem as RefProblem
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import problem_from_numpy
from repro_torch.core.population import run_gfl_population

ROOT = Path(__file__).resolve().parents[1]
COHORTS = ["importance,floor=0.2",
           "uniform+trace:diurnal,period=24,min=0.2"]
ITERS, TAIL, REPEATS, SES = 150, 15, 8, 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, which torch's thread pool slows
    when the test run's other processes hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    with np.load(ROOT / "data" / "fig2_problem0.npz") as d:
        return {k: d[k] for k in d.files}


def _kw(cohort):
    return dict(num_servers=10, clients_per_server=50, clients_sampled=10,
                topology="full", privacy="hybrid", sigma_g=0.2, mu=0.1,
                grad_bound=10.0, cohort=cohort)


@pytest.mark.parametrize("cohort", COHORTS)
def test_weighted_tails_match_the_reference_in_distribution(cohort, arrays):
    ref_prob = RefProblem(jnp.asarray(arrays["features"]),
                          jnp.asarray(arrays["labels"]),
                          float(arrays["rho"]), jnp.asarray(arrays["w_opt"]))
    prob = problem_from_numpy(arrays["features"], arrays["labels"],
                              arrays["rho"], arrays["w_opt"], device="cpu")
    rcfg, tcfg = RefConfig(**_kw(cohort)), GFLConfig(**_kw(cohort))
    ref_tails, tails = [], []
    for r in range(REPEATS):
        want = ref_run_pop(ref_prob, rcfg, iters=ITERS, batch_size=10,
                           seed=1000 + r)
        got = run_gfl_population(prob, tcfg, iters=ITERS, batch_size=10,
                                 seed=1000 + r)
        assert np.isfinite(got.msd).all()
        assert ((got.q > 0) & (got.q <= 1)).all()
        ref_tails.append(np.mean(np.asarray(want.msd)[-TAIL:]))
        tails.append(np.mean(got.msd[-TAIL:]))
    lp, lr = np.log(tails), np.log(ref_tails)
    se = np.sqrt(lp.var(ddof=1) / REPEATS + lr.var(ddof=1) / REPEATS)
    assert abs(lp.mean() - lr.mean()) <= SES * se, (
        cohort, np.exp(lp.mean()), np.exp(lr.mean()), se)


# ---------------------------------------------------------- entry points --


def test_population_demo_entry(capsys):
    mod = importlib.import_module("repro_torch.launch.population_demo")
    mod.main(["--reduced", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    header, *rows = list(csv.reader(out[1:5]))
    assert header == ["cohort", "msd_tail", "q_mean"]
    assert [r[0] for r in rows] == list(mod.COHORTS)
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert float(rows[0][2]) == pytest.approx(mod.L / mod.K)
    # a trace leaves fewer clients to draw from: q above L / K
    assert float(rows[1][2]) > mod.L / mod.K
    vals = dict(ln.split(",") for ln in out[5:])
    assert float(vals["population_demo/hybrid_epsilon_amplified"]) < \
        float(vals["population_demo/hybrid_epsilon"])
    assert float(vals["population_demo/scheduled_epsilon"]) == \
        pytest.approx(10.0)


def test_population_scale_entry(capsys):
    mod = importlib.import_module("repro_torch.launch.population_scale")
    rows = mod.main(["--reduced", "--device", "cpu", "--iters", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    header, *lines = list(csv.reader(out[1:]))
    assert tuple(header) == mod.COLUMNS
    assert [int(r[0]) for r in lines] == list(mod.VIRTUAL_KS)
    # on the CPU peak memory is not measured, and not asserted
    assert all(r[7] == "not_measured" for r in lines)
    assert [r["dense_bytes"] for r in rows] == [4 * K * 50 * 2 * 4
                                                for K in mod.VIRTUAL_KS]
    assert all(r["client_steps_per_sec"] > 0 for r in rows)
