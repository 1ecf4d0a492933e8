"""The port's live run monitor (``repro_torch.telemetry.watch``): the cases
of the reference's tests/test_watch.py on the port — the grammar, each
rule firing on a seeded violation and quiet on a clean stream, the
``--once`` gate's exit codes through ``python -m
repro_torch.telemetry.watch`` — and the port's alerts held against the
reference's on the same records.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.telemetry import watch as ref_watch
from repro_torch.telemetry.watch import (
    Watcher,
    parse_watch_spec,
    watch_to_spec,
)

REPO_ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- grammar

def test_parse_canonicalizes_and_round_trips():
    rules = parse_watch_spec("eps:0.9,target=4+nan+gap:0.05")
    assert [r.kind for r in rules] == ["eps", "nan", "gap"]
    assert rules[0].param("frac") == 0.9
    assert rules[0].param("target") == 4.0
    spec = watch_to_spec(rules)
    assert parse_watch_spec(spec) == rules


@pytest.mark.parametrize("bad", [
    "",                      # empty
    "bogus:1",               # unknown kind
    "gap",                   # missing required value
    "nan:0.5",               # nan takes no value
    "gap:0.05,target=4",     # parameter not allowed for this kind
    "eps:0.9,window=3",      # window is a throughput-only parameter
])
def test_parse_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_watch_spec(bad)


def test_throughput_window_defaults():
    (rule,) = parse_watch_spec("throughput:0.5")
    assert rule.param("window") == 20.0
    assert rule.to_spec() == "throughput:0.5,window=20"


# ----------------------------------------------------------- rule units

def _rec(stream, **kv):
    return {"stream": stream, "run": "r0", "t_wall": 0.0, **kv}


def test_eps_rule_fires_at_fraction():
    w = Watcher(parse_watch_spec("eps:0.9,target=4"))
    assert w.feed(_rec("privacy", step=1, eps=3.0, delta=0.0)) == []
    fired = w.feed(_rec("privacy", step=2, eps=3.7, delta=0.0))
    assert len(fired) == 1 and "eps_spent" in fired[0]["message"]
    # eps = inf is a meaningful ledger state, never an eps alert
    assert w.feed(_rec("privacy", step=3, eps=float("inf"),
                       delta=0.0)) == []


def test_eps_rule_uses_cli_target_fallback():
    w = Watcher(parse_watch_spec("eps:0.5"), epsilon_target=2.0)
    assert len(w.feed(_rec("privacy", step=1, eps=1.5, delta=0.0))) == 1
    # no target anywhere -> rule cannot evaluate, stays quiet
    assert Watcher(parse_watch_spec("eps:0.5")).feed(
        _rec("privacy", step=1, eps=1.5, delta=0.0)) == []


def test_gap_and_norm_rules():
    w = Watcher(parse_watch_spec("gap:0.05+norm:100"))
    assert w.feed(_rec("round", round=0, gap=0.2, update_norm=5.0)) == []
    fired = w.feed(_rec("round", round=1, gap=0.01, update_norm=500.0))
    assert {f["rule"].split(":")[0] for f in fired} == {"gap", "norm"}


def test_nan_rule_scans_series_and_exempts_privacy():
    w = Watcher(parse_watch_spec("nan"))
    assert w.feed(_rec("step", step=0, msd=[0.1, 0.2])) == []
    assert len(w.feed(_rec("step", step=1,
                           msd=[0.1, float("nan")]))) == 1
    assert len(w.feed(_rec("round", round=2, msd=float("inf")))) == 1
    assert w.feed(_rec("privacy", step=3, eps=float("inf"),
                       delta=0.0)) == []


def test_stale_rule():
    w = Watcher(parse_watch_spec("stale:4"))
    assert w.feed(_rec("step", step=0, staleness=[1.0, 3.5])) == []
    assert len(w.feed(_rec("step", step=1, staleness=[1.0, 9.0]))) == 1


def test_throughput_rule_needs_full_window_then_fires():
    w = Watcher(parse_watch_spec("throughput:0.5,window=4"))
    for i in range(4):
        assert w.feed(_rec("step", step=i, events=10.0)) == []
    fired = w.feed(_rec("step", step=4, events=2.0))
    assert len(fired) == 1 and "throughput drop" in fired[0]["message"]
    # the drop itself joins the trailing window afterwards
    assert w._events[-1] == 2.0


# ------------------------------------------------------------------ CLI

def _run_watch(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.watch", *args],
        capture_output=True, text=True, cwd=REPO_ROOT,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})


def test_cli_once_clean_exits_zero(tmp_path):
    jl = tmp_path / "run.jsonl"
    jl.write_text("\n".join(
        json.dumps(_rec("step", step=i, msd=0.5 / (i + 1), events=8.0))
        for i in range(5)) + "\n")
    proc = _run_watch(str(jl), "--rules", "nan+gap:0.05", "--once")
    assert proc.returncode == 0, proc.stderr
    assert "0 alert(s)" in proc.stdout


def test_cli_once_alerting_exits_one_and_writes_alerts(tmp_path):
    jl = tmp_path / "run.jsonl"
    alerts = tmp_path / "alerts.jsonl"
    recs = [_rec("round", round=0, msd=0.5, gap=0.2),
            _rec("round", round=1, msd=float("nan"), gap=0.01)]
    jl.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    proc = _run_watch(str(jl), "--rules", "nan+gap:0.05", "--once",
                      "--alerts", str(alerts))
    assert proc.returncode == 1, proc.stderr
    assert "ALERT" in proc.stderr
    lines = [json.loads(ln) for ln in alerts.read_text().splitlines()]
    assert {a["rule"].split(":")[0] for a in lines} == {"nan", "gap"}


def test_cli_bad_spec_and_missing_file_exit_two(tmp_path):
    jl = tmp_path / "run.jsonl"
    jl.write_text("")
    assert _run_watch(str(jl), "--rules", "bogus:1",
                      "--once").returncode == 2
    assert _run_watch(str(tmp_path / "nope.jsonl"),
                      "--once").returncode == 2


def test_alerts_equal_the_reference():
    """One record stream through both packages' watchers: the same alerts."""
    spec = ("eps:0.9,target=4+nan+gap:0.05+norm:100+stale:4"
            "+throughput:0.5,window=3+restart:2")
    recs = [_rec("step", step=i, events=10.0, update_norm=5.0)
            for i in range(3)]
    recs += [_rec("step", step=3, events=1.0, staleness=[1.0, 9.0]),
             _rec("round", round=4, msd=float("nan"), gap=0.01),
             _rec("privacy", step=5, eps=3.9, delta=0.0),
             _rec("fleet", tick=6, restarts=3),
             _rec("round", round=7, grad_norm_max=500.0, gap=0.2)]
    ours = Watcher(parse_watch_spec(spec))
    theirs = ref_watch.Watcher(ref_watch.parse_watch_spec(spec))
    for rec in recs:
        assert ours.feed(dict(rec)) == theirs.feed(dict(rec))
    assert len(ours.alerts) >= 7
    assert watch_to_spec(parse_watch_spec(spec)) == \
        ref_watch.watch_to_spec(ref_watch.parse_watch_spec(spec))
