"""Port vs reference: GFLConfig field by field, the topology families and
the accountant curves — all pure python/numpy, so exactly equal."""
import dataclasses
import math

import numpy as np
import pytest

from repro.configs import base as ref_base
from repro.configs import gfl_logreg as ref_logreg
from repro.core import topology as ref_topo
from repro.core.privacy import accountant as ref_acc
from repro.core.privacy import mechanism as ref_mech
from repro_torch.configs import base as t_base
from repro_torch.configs import gfl_logreg as t_logreg
from repro_torch.core import topology as t_topo
from repro_torch.core.privacy import accountant as t_acc
from repro_torch.core.privacy import mechanism as t_mech


def test_gfl_config_fields_and_defaults_equal():
    ref = [(f.name, f.default) for f in dataclasses.fields(ref_base.GFLConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(t_base.GFLConfig)]
    assert port == ref
    assert (t_base.GFLConfig(clients_sampled=7).effective_clients
            == ref_base.GFLConfig(clients_sampled=7).effective_clients)


def test_gfl_logreg_config_equal():
    assert dataclasses.asdict(t_logreg.GFL) == dataclasses.asdict(ref_logreg.GFL)
    assert t_logreg.RHO == ref_logreg.RHO
    assert t_logreg.DIM == ref_logreg.CONFIG.d_model


@pytest.mark.parametrize("topology,P", [
    ("ring", 5), ("ring", 10), ("torus", 8), ("torus", 12), ("full", 10),
    ("erdos", 9), ("hypercube", 8), ("expander", 10)])
def test_combination_matrix_exact(topology, P):
    A = t_topo.combination_matrix(topology, P, seed=3)
    R = ref_topo.combination_matrix(topology, P, seed=3)
    assert np.array_equal(A, R)
    assert t_topo.spectral_gap(A) == ref_topo.spectral_gap(R)
    assert t_topo.neighbor_lists(A) == ref_topo.neighbor_lists(R)


@pytest.mark.parametrize("topology,P", [("ring", 6), ("torus", 12)])
def test_permute_schedule_exact(topology, P):
    assert (t_topo.permute_schedule(topology, P)
            == ref_topo.permute_schedule(topology, P))


def test_validate_combination_matrix_same_verdicts():
    bad = np.array([[0.5, 0.5], [0.2, 0.8]])
    for mod in (t_topo, ref_topo):
        with pytest.raises(ValueError, match="symmetric"):
            mod.validate_combination_matrix(bad)
        with pytest.raises(ValueError, match="connected"):
            mod.validate_combination_matrix(np.eye(3))


@pytest.mark.parametrize("i", [1, 7, 200])
def test_epsilon_curves_exact(i):
    assert t_acc.epsilon_at(i, 0.1, 10.0, 0.2) == ref_acc.epsilon_at(
        i, 0.1, 10.0, 0.2)
    assert (t_acc.gaussian_epsilon_at(i, 0.1, 10.0, 0.2, 1e-6)
            == ref_acc.gaussian_epsilon_at(i, 0.1, 10.0, 0.2, 1e-6))
    for dist in ("laplace", "gaussian"):
        assert (t_acc.scheduled_sigma_at(i, 0.1, 10.0, 500, 3.0, dist)
                == ref_acc.scheduled_sigma_at(i, 0.1, 10.0, 500, 3.0, dist))
    assert (t_acc.amplified_release_epsilon(0.01 * i, 0.2)
            == ref_acc.amplified_release_epsilon(0.01 * i, 0.2))
    assert t_acc.sigma_for_epsilon(i, 0.1, 10.0, 2.0) == \
        ref_acc.sigma_for_epsilon(i, 0.1, 10.0, 2.0)


@pytest.mark.parametrize("curve", ["laplace_thm2", "gaussian", "scheduled",
                                   "none"])
def test_privacy_accountant_ledger_exact(curve):
    kw = dict(mu=0.1, grad_bound=10.0, sigma_g=0.3, curve=curve,
              horizon=50, epsilon_target=4.0,
              distribution="gaussian" if curve == "gaussian" else "laplace")
    a, r = t_acc.PrivacyAccountant(**kw), ref_acc.PrivacyAccountant(**kw)
    for q in (1.0, 0.5, 0.2, 0.2):
        assert a.advance(3, q=q) == r.advance(3, q=q)
    assert a.history == r.history
    assert a.amplified_epsilon() == r.amplified_epsilon()
    assert a.amplified_delta() == r.amplified_delta()
    assert a.delta_spent() == r.delta_spent()
    assert a.amplification_curve(5, 0.3) == r.amplification_curve(5, 0.3)
    if curve in ("laplace_thm2", "gaussian"):
        assert a.sigma_schedule(100, 5.0) == r.sigma_schedule(100, 5.0)


@pytest.mark.parametrize("scheme", ["none", "iid_dp", "hybrid",
                                    "gaussian_dp", "scheduled",
                                    "scheduled:gaussian_dp"])
@pytest.mark.parametrize("target", [0.0, 7.5])
def test_noise_profiles_and_accountants_equal(scheme, target):
    kw = dict(privacy=scheme, sigma_g=0.2, epsilon_target=target,
              epsilon_horizon=40)
    tp = t_mech.mechanism_for(t_base.GFLConfig(**kw))
    rp = ref_mech.mechanism_for(ref_base.GFLConfig(**kw))
    assert dataclasses.asdict(tp.noise_profile()) == \
        dataclasses.asdict(rp.noise_profile())
    ta, ra = tp.accountant(), rp.accountant()
    ta.advance(40)
    ra.advance(40)
    e1, e2 = ta.epsilon(), ra.epsilon()
    assert e1 == e2 or (math.isinf(e1) and math.isinf(e2))


def test_registry_names_equal():
    assert t_mech.list_mechanisms() == ref_mech.list_mechanisms()
    with pytest.raises(ValueError, match="cannot wrap itself"):
        t_mech.get_mechanism("scheduled:scheduled", t_base.GFLConfig())
