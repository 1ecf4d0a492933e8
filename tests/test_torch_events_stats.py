"""The event engine's statistics against the reference, and the async
bench entry, on the CPU.

Generator-seeded draws cannot reproduce the reference's threefry draws,
and the two packages' lazy synthetic populations hash their data
differently, so an event run's MSD tail is held to the reference's in
distribution, as ``tests/test_torch_fig2.py`` holds the Fig. 2 tails.
Both packages run P=4 servers of K=40 virtual ``synthetic:hetero``
clients, a diurnal trace (``uniform+trace:diurnal,period=12,min=0.3``),
``async:buffer=8,latency=lognorm:0.5,max_stale=3,rate=6``, ring, sigma
0.2, mu 0.1, B 10, batch 5, 60 ticks, eight repeats each (seeds
1000..1007, each over its own population, data seeds 0..7: the two
packages' populations are equal only in distribution); a repeat's tail is
its mean MSD over the last 10 ticks.  The mean log tails must agree
within ``SES`` = 4 standard errors of their difference (sqrt(s_port^2 / 8
+ s_ref^2 / 8)): for normal log tails a false alarm at under 1e-4.  Seeds
are fixed, so the test is deterministic.
"""
import csv
import importlib

import numpy as np
import pytest
import torch

from repro.configs.base import GFLConfig as RefConfig
from repro.core.events import run_gfl_async as ref_run_async
from repro_torch.configs.base import GFLConfig
from repro_torch.core.events import run_gfl_async

TICKS, TAIL, REPEATS, SES = 60, 10, 8, 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, which torch's thread pool slows
    when the test run's other processes hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(scheme, r):
    return dict(data_seed=r, num_servers=4, clients_per_server=40,
                privacy=scheme, sigma_g=0.2, mu=0.1, grad_bound=10.0, topology="ring",
                population="synthetic:hetero",
                cohort="uniform+trace:diurnal,period=12,min=0.3",
                async_spec="async:buffer=8,latency=lognorm:0.5,max_stale=3,"
                           "rate=6")


@pytest.mark.parametrize("scheme", ["none", "iid_dp", "hybrid"])
def test_event_tails_match_the_reference_in_distribution(scheme):
    ref_tails, tails = [], []
    for r in range(REPEATS):
        rcfg, tcfg = RefConfig(**_kw(scheme, r)), GFLConfig(**_kw(scheme,
                                                                   r))
        want = ref_run_async(None, rcfg, ticks=TICKS, batch_size=5,
                             seed=1000 + r)
        got = run_gfl_async(None, tcfg, ticks=TICKS, batch_size=5,
                            seed=1000 + r, device="cpu")
        assert np.isfinite(got.msd).all()
        assert got.flushed.any() and (got.q[got.flushed] > 0).all()
        ref_tails.append(np.mean(np.asarray(want.msd)[-TAIL:]))
        tails.append(np.mean(got.msd[-TAIL:]))
    lp, lr = np.log(tails), np.log(ref_tails)
    se = np.sqrt(lp.var(ddof=1) / REPEATS + lr.var(ddof=1) / REPEATS)
    assert abs(lp.mean() - lr.mean()) <= SES * se, (
        scheme, np.exp(lp.mean()), np.exp(lr.mean()), se)


# ---------------------------------------------------------- entry point --


def test_async_throughput_entry(capsys):
    mod = importlib.import_module("repro_torch.launch.async_throughput")
    rows = mod.main(["--reduced", "--device", "cpu", "--ticks", "12"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# device: cpu"
    header, *lines = list(csv.reader(out[1:]))
    assert tuple(header) == mod.COLUMNS
    assert [r[0] for r in lines] == ["sync"] + [
        f"buf{b}_stale{s}" for b in (2, 4, 8) for s in mod.STALE_BOUNDS]
    sync, grid = rows[0], rows[1:]
    # the sync row is the lockstep schedule: every server every tick
    assert sync["releases_per_server_mean"] == 12
    assert sync["events_folded"] == 4 * 4 * 12
    assert all(r["events_per_sec"] > 0 and r["ticks"] == 12 for r in rows)
    # a larger buffer releases less often on the same arrivals
    by_buf = {r["buffer"]: r["releases_per_server_mean"] for r in grid
              if r["max_stale"] == 2}
    assert by_buf[2] > by_buf[4] > by_buf[8]
    assert all(r["mean_staleness"] <= r["max_stale"] for r in grid)
