"""The port's spec-grammar registry (``repro_torch.core.specs``): the cases
of the reference's tests/test_specs.py on the port, and the registry held
against the reference's — the same eight grammars with the same examples,
each parsed to the same canonical spec by both packages."""
import pytest

from hypothesis_compat import given, settings, st
from repro.core import specs as ref_specs
from repro_torch.core.population.population import (PopulationSpec,
                                                    parse_population_spec,
                                                    population_to_spec)
from repro_torch.core.specs import (SpecGrammar, all_grammars, get_grammar,
                                    register_grammar)

EXPECTED = {"async", "cohort", "fault", "fleet", "latency", "population",
            "trace", "watch"}


def test_registry_inventory():
    assert set(all_grammars()) == EXPECTED
    g = get_grammar("fault")
    assert isinstance(g, SpecGrammar) and g.examples
    with pytest.raises(KeyError):
        get_grammar("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_grammar("fault", g.parse, g.to_spec)


def _cases():
    for name, g in sorted(all_grammars().items()):
        assert g.examples, f"grammar {name!r} ships no examples"
        for ex in g.examples:
            yield pytest.param(name, ex, id=f"{name}-{ex}")


@pytest.mark.parametrize("name,example", list(_cases()))
def test_round_trip_law(name, example):
    """parse(to_spec(parse(s))) == parse(s), and canonical forms are
    fixed points of to_spec(parse(.))."""
    g = get_grammar(name)
    parsed = g.parse(example)
    canonical = g.to_spec(parsed)
    reparsed = g.parse(canonical)
    assert reparsed == parsed
    assert g.to_spec(reparsed) == canonical


def test_registry_equals_the_reference():
    ours, theirs = all_grammars(), ref_specs.all_grammars()
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].examples == theirs[name].examples, name


@pytest.mark.parametrize("name,example", list(_cases()))
def test_canonical_form_equals_the_reference(name, example):
    ours = get_grammar(name)
    theirs = ref_specs.get_grammar(name)
    assert ours.to_spec(ours.parse(example)) == \
        theirs.to_spec(theirs.parse(example))


# ---- population grammar --------------------------------------------------
def test_population_to_spec_canonical_forms():
    assert population_to_spec(parse_population_spec("dense")) == "dense"
    assert population_to_spec(
        parse_population_spec("synthetic")) == "synthetic:hetero"
    assert population_to_spec(
        parse_population_spec("dirichlet:0.3,pool=4000")) \
        == "dirichlet:0.3,pool=4000"
    s = population_to_spec(parse_population_spec("dirichlet,alpha=1"))
    assert parse_population_spec(s).args["alpha"] == 1
    assert isinstance(parse_population_spec(s).args["alpha"], int)


def test_population_to_spec_rejects_nothing_parse_accepts():
    for spec in ("dense", "synthetic:iid,sigma=1.0,n=40,dim=8",
                 "synthetic:mixture,clusters=3,drift=0.25,rho=0.1",
                 "dirichlet:0.5,pool=100,sigma=2.0"):
        assert parse_population_spec(population_to_spec(
            parse_population_spec(spec))) == parse_population_spec(spec)


@settings(max_examples=50, deadline=None)
@given(
    kind=st.sampled_from(["iid", "hetero", "mixture", "dirichlet"]),
    sigma=st.floats(0.01, 10.0, allow_nan=False),
    n=st.integers(1, 1000),
)
def test_population_round_trip_property(kind, sigma, n):
    args = {"n": n}
    if kind in ("iid", "mixture", "dirichlet"):
        args["sigma"] = float(sigma)
    if kind == "mixture":
        args["clusters"] = 3
    if kind == "dirichlet":
        args["alpha"] = float(sigma)
    spec = PopulationSpec(kind, args)
    assert parse_population_spec(population_to_spec(spec)) == spec


# ---- the fleet grammar, pulled ahead of the fleet ------------------------
@pytest.mark.parametrize("bad", ["fleet:", "fleet:transport=pigeon",
                                 "fleet:retry=-1", "fleet:timeout=0",
                                 "fleet:retry=2,retry=3", "nest:retry=1",
                                 "fleet:backoff=linear", "fleet:nope=1"])
def test_fleet_rejections_equal_the_reference(bad):
    from repro.core.fleet.spec import parse_fleet_spec as ref_parse
    from repro_torch.core.fleet import parse_fleet_spec
    with pytest.raises(ValueError):
        parse_fleet_spec(bad)
    with pytest.raises(ValueError):
        ref_parse(bad)


def test_fleet_backoff_equals_the_reference():
    from repro.core.fleet.spec import parse_fleet_spec as ref_parse
    from repro_torch.core.fleet import parse_fleet_spec
    for spec in ("fleet", "fleet:backoff=const,timeout=0.5"):
        ours, theirs = parse_fleet_spec(spec), ref_parse(spec)
        assert [ours.backoff_delay(a) for a in range(4)] == \
            [theirs.backoff_delay(a) for a in range(4)]
