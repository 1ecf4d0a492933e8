"""The port's telemetry layer (``repro_torch.telemetry``): the cases of the
reference's tests/test_telemetry.py on the port, and the port held against
the reference on every engine.

The two-sided contract: ``telemetry=off`` is bitwise an uninstrumented run
(no buffer is made, the round has no extra op) and ``telemetry=on``
observes without perturbing — the same params and traces, with
schema-valid records.  The in-graph tap is a device buffer drained after
the run (``MetricsStream``), where the reference flushes through
``io_callback``; the records must still be the reference's: the same
streams, counts and field sets on the dense, population (loop and scan),
weighted and event engines, and with the reference's draws replayed
(eager) the ``step`` stream's values within atol 1e-5.

Small shapes on the CPU; one intra-op thread (many small ops)."""
import dataclasses
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.telemetry as ref_tm
from hypothesis_compat import given, settings, st
from repro.configs.base import GFLConfig as RefConfig
from repro.core.events import engine as ref_events
from repro.core.population import engine as ref_pop_engine
from repro.core.population.population import DensePopulation as RefDense
from repro.core.simulate import generate_problem as ref_generate
from repro.core.simulate import run_gfl as ref_run_gfl
from repro_torch.configs.base import GFLConfig
from repro_torch.convert import problem_from_numpy
from repro_torch.core.events import run_gfl_async
from repro_torch.core.population import (DensePopulation, SyntheticPopulation,
                                         run_gfl_population)
from repro_torch.core.simulate import run_gfl
from repro_torch.draws import ReplayDraws
from repro_torch.telemetry import (MetricsStream, QuantileSketch, RunLog,
                                   SchemaError, emit, get_schema,
                                   list_schemas, session, telemetry_active,
                                   trace_span, validate_record)
from repro_torch.telemetry import stream as tm_stream

from test_torch_events import async_run_draws
from test_torch_parity import run_gfl_draws

REPO_ROOT = Path(__file__).resolve().parents[1]
ENVELOPE = ("stream", "run", "t_wall")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def telemetry_dir(tmp_path, monkeypatch):
    """Sessions opened from a config write their trace under tmp_path."""
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path))


# ------------------------------------------------------------------ schema

def test_schemas_registered_and_validate():
    names = set(list_schemas())
    assert {"round", "step", "privacy", "kernel", "mesh"} <= names
    validate_record("round", {"round": 0, "msd": 0.5, "engine": "population"})
    with pytest.raises(SchemaError):
        validate_record("round", {"round": 0, "bogus_field": 1.0})
    with pytest.raises(SchemaError):
        validate_record("round", {"msd": 0.5})      # index missing
    with pytest.raises(SchemaError):
        validate_record("no_such_stream", {"x": 1})
    assert get_schema("privacy").index == "step"


def test_schemas_are_the_references():
    ours, theirs = list_schemas(), ref_tm.list_schemas()
    assert sorted(ours) == sorted(theirs)
    for name, schema in theirs.items():
        assert ours[name].index == schema.index
        assert [(f.name, f.kind) for f in ours[name].fields] == \
            [(f.name, f.kind) for f in schema.fields]


# ---------------------------------------------------------------- sessions

def test_emit_is_noop_without_session():
    assert not telemetry_active()
    emit("round", {"round": 0, "bogus_field": 1.0})  # not even validated


def test_emit_host_and_in_graph():
    """Host values and tensors through ``emit``; a round body's rows
    through a device buffer written at a device counter and drained."""
    with session("memory") as sess:
        assert telemetry_active()
        emit("round", {"round": 0, "msd": torch.tensor(1.0),
                       "engine": "test"})
        ms = MetricsStream("step", ("step", "msd"), length=3)
        counter = torch.zeros(1, dtype=torch.int64)
        for x in (3.0, 4.0, 5.0):
            ms.tap(counter, {"msd": torch.tensor(x) * 2})
            counter.add_(1)
        assert ms.drain() == 3
        assert len(sess.memory_records("round")) == 1
        steps = sess.memory_records("step")
        assert [(r["step"], r["msd"]) for r in steps] == \
            [(1, 6.0), (2, 8.0), (3, 10.0)]
        assert all(r["stream"] == "step" and "t_wall" in r for r in steps)
    assert not telemetry_active()


def test_emit_refuses_a_capturing_stream(monkeypatch):
    """A captured round may not sync with the host: ``emit`` raises while
    a CUDA stream captures; ``note`` (host values only) does not."""
    monkeypatch.setattr(tm_stream, "capturing", lambda: True)
    with session("memory") as sess:
        with pytest.raises(RuntimeError, match="capturing"):
            emit("round", {"round": 0, "msd": 1.0})
        tm_stream.note("kernel", {"seq": 1, "op": "fold_norms"})
        with pytest.raises(TypeError, match="tensor"):
            tm_stream.note("kernel", {"seq": 2, "d_pad": torch.tensor(3)})
        assert len(sess.memory_records("kernel")) == 1


def test_nested_session_is_passthrough():
    with session("memory") as outer:
        with session("memory") as inner:
            assert inner is outer
            emit("round", {"round": 0, "msd": 0.0})
        assert telemetry_active()       # inner exit must not close outer
        assert len(outer.memory_records("round")) == 1


def test_metrics_stream_accumulates_in_scan():
    ms = MetricsStream("step", ("step", "events", "events_total"),
                       cumulative={"events_total": "events"}, length=3)
    with session("memory") as sess:
        for i, x in enumerate((2, 3, 4)):
            ms.tap(i, {"events": torch.tensor(x, dtype=torch.int32)})
        ms.drain()
        recs = sess.memory_records("step")
    assert [r["events"] for r in recs] == [2, 3, 4]
    assert [r["events_total"] for r in recs] == [2, 5, 9]
    assert [r["step"] for r in recs] == [1, 2, 3]


def test_trace_span_writes_chrome_json(tmp_path):
    trace = tmp_path / "t.trace.json"
    with session("memory", trace_path=trace):
        with trace_span("outer", detail="x"):
            with trace_span("inner"):
                pass
    doc = json.loads(trace.read_text())
    events = doc["traceEvents"]
    assert {e["name"] for e in events} >= {"outer", "inner"}
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0 and "ts" in e
    with trace_span("nobody"):
        pass


# ------------------------------------------------------------------- sinks

def test_jsonl_and_csv_sinks(tmp_path):
    jl = tmp_path / "run.jsonl"
    cb = tmp_path / "run"
    with session(f"jsonl:{jl}+csv:{cb}"):
        emit("round", {"round": 0, "msd": 0.25, "engine": "test"})
        emit("round", {"round": 1, "msd": 0.125, "engine": "test"})
        emit("privacy", {"step": 1, "eps": float("inf"), "delta": 0.0})
    recs = [json.loads(ln) for ln in jl.read_text().splitlines()]
    assert len(recs) == 3
    for r in recs:
        validate_record(r["stream"],
                        {k: v for k, v in r.items() if k not in ENVELOPE})
    assert recs[2]["eps"] == float("inf")
    lines = (tmp_path / "run.round.csv").read_text().splitlines()
    assert lines[0].startswith("run,t_wall,round,engine")
    assert len(lines) == 3


def test_console_sink_runs(capfd):
    with session("console:1"):
        emit("round", {"round": 0, "msd": 0.5, "q": 0.1, "engine": "t"})
        emit("round", {"round": 1, "msd": 0.25, "q": 0.1, "engine": "t"})
    cap = capfd.readouterr()
    out = cap.out + cap.err
    assert "msd" in out and "round" in out


def test_console_every_arg_decimates(capfd):
    from repro_torch.telemetry.sinks import ConsoleSink, sink_from_spec
    sink = sink_from_spec("console:3")
    assert isinstance(sink, ConsoleSink) and sink.every == 3
    with session("console:3"):
        for i in range(7):
            emit("round", {"round": i, "msd": float(100 + i),
                           "engine": "t"})
    cap = capfd.readouterr()
    out = cap.out + cap.err
    assert "102" in out and "105" in out
    assert "101" not in out and "104" not in out and "106" not in out


def test_bad_sink_spec_rejected():
    with pytest.raises(ValueError):
        with session("carrier_pigeon"):
            pass


# ------------------------------------------------- batched drain / profile

def test_metrics_stream_buffered_matches_per_round():
    """flush_every=3 delivers record for record what flush_every=1 does
    (the partial batch at the tail included)."""
    def collect(flush_every):
        ms = MetricsStream("step", ("step", "events", "events_total"),
                           cumulative={"events_total": "events"}, length=7,
                           flush_every=flush_every)
        with session("memory") as sess:
            for i in range(7):
                ms.tap(i, {"events": torch.tensor(i + 1)})
            ms.drain()
            recs = sess.memory_records("step")
        return [{k: r[k] for k in ("step", "events", "events_total")}
                for r in recs]

    assert collect(1) == collect(3)
    assert len(collect(3)) == 7


def test_metrics_stream_buffered_requires_fields():
    with pytest.raises(KeyError):
        MetricsStream("step", ("step", "bogus"), length=4)
    with pytest.raises(ValueError, match="kind"):
        MetricsStream("round", ("staleness",), length=4)   # a series
    ms = MetricsStream("step", ("step", "msd"), length=2)
    with pytest.raises(ValueError, match="fields"):
        ms.tap(0, {"msd": torch.tensor(1.0), "events": torch.tensor(2)})


def test_flush_every_env(monkeypatch):
    from repro_torch.telemetry import flush_every_from_env
    monkeypatch.delenv("REPRO_TELEMETRY_FLUSH_EVERY", raising=False)
    assert flush_every_from_env() == 1
    monkeypatch.setenv("REPRO_TELEMETRY_FLUSH_EVERY", "8")
    assert flush_every_from_env() == 8
    assert MetricsStream("step", ("step",), length=1).flush_every == 8
    monkeypatch.setenv("REPRO_TELEMETRY_FLUSH_EVERY", "junk")
    assert flush_every_from_env() == 1


def test_profile_stream_attributes_compile():
    """Captures and nvcc builds inside a phase (their hooks called as the
    round graph and the build call them) are its compile_s, retraces and
    compiles; a drain is its callback_s; no peak_bytes on the CPU.  A
    capture of a graph key captured before is compile_s, not a retrace."""
    from repro_torch.telemetry import profile
    key = ("test_profile_stream_attributes_compile", object())
    with session("memory", profile=True) as sess:
        with trace_span("fresh_capture", tag="t"):
            profile.note_warmup(0.01)
            profile.note_capture(0.02, key)
            profile.note_build(0.5, 3)
            ms = MetricsStream("step", ("step", "msd"), length=4)
            ms.drain()
        with trace_span("again"):
            profile.note_capture(0.03, key)
    recs = sess.memory_records("profile")
    assert [r["phase"] for r in recs] == ["fresh_capture", "again"]
    r = recs[0]
    validate_record("profile", {k: v for k, v in r.items()
                                if k not in ENVELOPE})
    assert r["retraces"] == 1 and r["compiles"] == 3
    assert r["compile_s"] == pytest.approx(0.53)
    assert r["wall_s"] >= r["callback_s"] > 0.0
    assert r["execute_s"] >= 0.0
    assert "peak_bytes" not in r
    assert recs[1]["retraces"] == 0 and recs[1]["compiles"] == 0
    assert recs[1]["compile_s"] == pytest.approx(0.03)


def test_graph_key_is_the_shape_of_the_round():
    """The key a capture is counted by: equal for two runs of one shape,
    whatever their seed, w_ref or telemetry setting; another length, a
    combine variant, another config or a tap is another key."""
    from repro_torch.core import gfl
    from repro_torch.core.population.graphed import graph_key
    from repro_torch.core.simulate import make_grad_fn
    cfg = GFLConfig(num_servers=4, clients_per_server=10, clients_sampled=3,
                    privacy="hybrid", sigma_g=0.3, mu=0.1, topology="ring")
    A = np.full((4, 4), 0.25, np.float32)

    def key(c=cfg, iters=6, combine=True, tap=False):
        step = gfl.StagedStep(A, make_grad_fn(0.1), c, 4, 3, iters, "cpu")
        if tap:
            step.norms_tap = MetricsStream(
                "step", ("step", "update_norm", "param_norm"), length=iters)
        return graph_key(step, iters, combine)

    base = key()
    assert key() == base
    assert key(dataclasses.replace(cfg, telemetry="memory",
                                   sanitize=True)) == base
    assert key(iters=7) != base
    assert key(combine=False) != base
    assert key(dataclasses.replace(cfg, mu=0.2)) != base
    assert key(tap=True) != base


def test_profile_off_by_default():
    with session("memory") as sess:
        with trace_span("plain"):
            pass
    assert sess.memory_records("profile") == []


def test_jaxprof_env_passthrough(monkeypatch):
    """REPRO_TELEMETRY_JAXPROF (the reference's variable) makes every span
    a torch.profiler.record_function too."""
    from repro_torch.telemetry.trace import SpanTracer
    monkeypatch.delenv("REPRO_TELEMETRY_JAXPROF", raising=False)
    assert SpanTracer().annotate is False
    monkeypatch.setenv("REPRO_TELEMETRY_JAXPROF", "1")
    tracer = SpanTracer()
    assert tracer.annotate is True
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("annotated", k=1):
            torch.ones(2).sum()
    assert [e["name"] for e in tracer.events] == ["annotated"]
    assert "annotated" in {e.key for e in prof.key_averages()}
    assert SpanTracer(annotate=False).annotate is False
    monkeypatch.setenv("REPRO_TELEMETRY_JAXPROF", "0")
    assert SpanTracer().annotate is False


# ------------------------------------------------------------------ sketch

def _rank_error(data, est, q):
    data = np.sort(np.asarray(data))
    rank = np.searchsorted(data, est) / max(len(data) - 1, 1)
    return abs(rank - q)


def test_sketch_rank_error_vs_numpy():
    rng = np.random.default_rng(0)
    data = rng.normal(size=5000)
    sk = QuantileSketch(k=128)
    sk.extend(data)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert _rank_error(data, sk.quantile(q), q) < 0.05, q
    assert sk.min == data.min() and sk.max == data.max()


def test_sketch_merge_invariance():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=3000), rng.normal(loc=2.0, size=2000)
    both = np.concatenate([a, b])
    sa, sb = QuantileSketch(k=128), QuantileSketch(k=128)
    sa.extend(a)
    sb.extend(b)
    merged = sa.merge(sb)
    for q in (0.25, 0.5, 0.75):
        assert _rank_error(both, merged.quantile(q), q) < 0.08, q


def test_sketch_serialization_roundtrip():
    sk = QuantileSketch(k=16)
    sk.extend(range(100))
    back = QuantileSketch.from_dict(sk.to_dict())
    assert back.quantile(0.5) == sk.quantile(0.5)
    assert back.min == sk.min and back.max == sk.max
    ref = ref_tm.QuantileSketch(k=16)
    ref.extend(range(100))
    assert sk.to_dict() == ref.to_dict()


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6,
                          allow_nan=False), min_size=2, max_size=400),
       st.integers(min_value=1, max_value=399))
def test_sketch_merge_matches_bulk(values, cut):
    cut = min(cut, len(values) - 1)
    bulk = QuantileSketch(k=64)
    bulk.extend(values)
    left, right = QuantileSketch(k=64), QuantileSketch(k=64)
    left.extend(values[:cut])
    right.extend(values[cut:])
    merged = left.merge(right)
    for q in (0.0, 0.5, 1.0):
        assert _rank_error(values, merged.quantile(q), q) <= \
            _rank_error(values, bulk.quantile(q), q) + 0.25


# ------------------------------------------------------------------ runlog

def test_runlog_rows_and_stack():
    log = RunLog("test_engine", stream="round")
    log.row(0, msd=1.0, gap=None)
    log.row(1, msd=0.5, gap=0.3)
    assert log.column("msd") == [1.0, 0.5]
    assert log.stack("gap").shape == (1,)
    assert log.stack("nothing") is None


def test_runlog_extend_arrays_validates_lengths():
    log = RunLog("test_engine")
    with pytest.raises(ValueError):
        log.extend_arrays({"msd": np.zeros(3), "q": np.zeros(4)})


# -------------------------------------------------- engine bit-identity

def _pop_cfg(privacy, **kw):
    return GFLConfig(num_servers=3, clients_per_server=20,
                     clients_sampled=4, topology="ring", privacy=privacy,
                     sigma_g=0.1, mu=0.1, grad_bound=10.0, **kw)


def _synthetic():
    return SyntheticPopulation(3, 20, mode="hetero", N=30, M=2, data_seed=0,
                               device="cpu")


@pytest.mark.parametrize("privacy", ["none", "iid_dp", "hybrid"])
@pytest.mark.parametrize("scan", [False, True])
def test_population_off_identical_and_on_pure(privacy, scan):
    pop = _synthetic()
    kw = dict(iters=4, batch_size=5, seed=0, scan=scan)
    base = run_gfl_population(pop, _pop_cfg(privacy), **kw)
    off = run_gfl_population(pop, _pop_cfg(privacy, telemetry="off"), **kw)
    with session("memory") as sess:
        on = run_gfl_population(pop, _pop_cfg(privacy, telemetry="memory"),
                                **kw)
        recs = sess.memory_records("round")
    assert base.msd.tolist() == off.msd.tolist() == on.msd.tolist()
    assert torch.equal(base.params, off.params)
    assert torch.equal(base.params, on.params)
    msd_stream = [r["msd"] for r in recs if "msd" in r]
    np.testing.assert_allclose(on.msd, msd_stream)


@pytest.mark.parametrize("privacy", ["none", "iid_dp", "hybrid"])
def test_dense_engine_off_identical(privacy):
    from repro_torch import rng
    from repro_torch.core.simulate import generate_problem
    prob = generate_problem(rng(0, "cpu"), P=3, K=8, N=30, M=2)
    cfg_off = GFLConfig(num_servers=3, clients_per_server=8,
                        topology="ring", privacy=privacy, sigma_g=0.1,
                        mu=0.1, grad_bound=10.0)
    msd0, p0 = run_gfl(prob, cfg_off, iters=3, batch_size=4, seed=0)
    with session("memory"):
        cfg_on = dataclasses.replace(cfg_off, telemetry="memory")
        msd1, p1 = run_gfl(prob, cfg_on, iters=3, batch_size=4, seed=0)
    assert msd0.tolist() == msd1.tolist()
    assert torch.equal(p0, p1)


@pytest.mark.parametrize("scan", [False, True])
def test_async_engine_off_identical_and_streams(scan):
    pop = SyntheticPopulation(3, 24, mode="hetero", N=30, M=2, data_seed=0,
                              device="cpu")
    spec = "async:buffer=4,rate=4,latency=exp:0.7,max_stale=2"
    kw = dict(ticks=5, batch_size=5, seed=0, scan=scan)
    off = run_gfl_async(pop, _pop_cfg("hybrid", async_spec=spec), **kw)
    with session("memory") as sess:
        on = run_gfl_async(pop, _pop_cfg("hybrid", async_spec=spec,
                                         telemetry="memory"), **kw)
        rounds = sess.memory_records("round")
        privacy = sess.memory_records("privacy")
    assert off.msd.tolist() == on.msd.tolist()
    assert torch.equal(off.params, on.params)
    for field in ("q", "staleness", "flushed", "events", "dropped_stale"):
        assert np.array_equal(getattr(off, field), getattr(on, field))
    assert len(rounds) == 5
    np.testing.assert_allclose(on.msd, [r["msd"] for r in rounds])
    np.testing.assert_array_equal(
        on.flushed.astype(np.int32),
        np.asarray([r["flushed"] for r in rounds], np.int32))
    assert privacy, "async accounting must emit the privacy stream"
    assert {r["server"] for r in privacy} >= {"server0"}
    for r in privacy:
        assert r["eps"] >= 0 or r["eps"] == float("inf")


def test_population_kernels_off_identical():
    """The kernels on (their plain versions here), telemetry on and off."""
    pop = _synthetic()
    kw = dict(iters=3, batch_size=5, seed=0, scan=False)
    off = run_gfl_population(pop, _pop_cfg("hybrid", use_kernels=True), **kw)
    with session("memory") as sess:
        on = run_gfl_population(
            pop, _pop_cfg("hybrid", use_kernels=True, telemetry="memory"),
            **kw)
        kernels = sess.memory_records("kernel")
    assert off.msd.tolist() == on.msd.tolist()
    assert torch.equal(off.params, on.params)
    # one record an (op, shape), though the eager rounds dispatch each op
    # every round
    assert sorted(r["op"] for r in kernels) == sorted(
        ["fold_norms", "fold_apply", "round_fold.traffic", "graph_combine"])
    assert all(r["backend"] == "plain" for r in kernels)
    traffic = [r for r in kernels if r["op"] == "round_fold.traffic"][0]
    assert traffic["mode"] == "mask" and traffic["pld_passes"] == 2
    assert traffic["hbm_bytes"] < traffic["hbm_bytes_ref"]


def test_env_flag_opens_a_session(monkeypatch, tmp_path):
    jl = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_TELEMETRY", f"jsonl:{jl}")
    run_gfl_population(_synthetic(), _pop_cfg("hybrid"), iters=3,
                       batch_size=5)
    streams = [json.loads(ln)["stream"] for ln in jl.read_text().splitlines()]
    assert streams.count("round") == 3 and streams.count("step") == 3
    assert (tmp_path / "env.trace.json").exists()


# ------------------------------------ against the reference, every engine

P, K, N, M = 4, 12, 20, 2     # test_torch_events' problem


@pytest.fixture(scope="module")
def ref_problem():
    return ref_generate(jax.random.PRNGKey(0), P=P, K=K, N=N, M=M)


@pytest.fixture(scope="module")
def problem(ref_problem):
    return problem_from_numpy(ref_problem.features, ref_problem.labels,
                              ref_problem.rho, ref_problem.w_opt,
                              device="cpu")


def _records(sess):
    by = defaultdict(list)
    for r in sess.memory_records():
        by[r["stream"]].append({k: v for k, v in r.items()
                                if k not in ENVELOPE})
    return dict(by)


def _ref_session(fn, tmp_path):
    with ref_tm.session("memory", trace_path=tmp_path / "r.json") as sess:
        out = fn()
    return out, _records(sess)


def _port_session(fn, tmp_path):
    with session("memory", trace_path=tmp_path / "p.json") as sess:
        out = fn()
    return out, _records(sess)


ENGINE_CASES = {
    # name: (config overrides, run kwargs, engine)
    "dense": (dict(), dict(record_every=1), "dense"),
    "dense_faulted": (dict(fault="links:0.3"), dict(), "dense"),
    "population_loop": (dict(clients_sampled=5), dict(record_every=2),
                        "population"),
    "population_scan": (dict(clients_sampled=5), dict(scan=True),
                        "population"),
    "weighted": (dict(clients_sampled=5, cohort="importance,floor=0.2"),
                 dict(), "population"),
    "events": (dict(async_spec="async:buffer=10,latency=lognorm:0.7,"
                               "max_stale=3,rate=8"), dict(), "async"),
    "events_scan": (dict(async_spec="async:buffer=10,latency=lognorm:0.7,"
                                    "max_stale=3,rate=8"),
                    dict(scan=True), "async"),
    "events_lockstep": (dict(async_spec="async:buffer=5"), dict(), "async"),
}


def _engine_kw(name, telemetry="memory", use_kernels=False):
    over, _, _ = ENGINE_CASES[name]
    return {**dict(num_servers=P, clients_per_server=K, clients_sampled=4,
                   privacy="hybrid", sigma_g=0.3, mu=0.1, topology="ring",
                   grad_bound=5.0, topology_seed=3, telemetry=telemetry,
                   use_kernels=use_kernels), **over}


def _run_port(name, problem, cfg, **extra):
    _, run_kw, engine = ENGINE_CASES[name]
    kw = dict(batch_size=5, seed=3, **run_kw, **extra)
    if engine == "dense":
        return run_gfl(problem, cfg, iters=4, **kw)
    if engine == "population":
        return run_gfl_population(DensePopulation.from_problem(problem),
                                  cfg, iters=4, **kw)
    return run_gfl_async(problem, cfg, ticks=4, **kw)


def _run_ref(name, ref_problem, rcfg):
    _, run_kw, engine = ENGINE_CASES[name]
    kw = dict(batch_size=5, seed=3, **run_kw)
    if engine == "dense":
        return ref_run_gfl(ref_problem, rcfg, iters=4, **kw)
    if engine == "population":
        return ref_pop_engine.run_gfl_population(
            RefDense.from_problem(ref_problem), rcfg, iters=4, **kw)
    return ref_events.run_gfl_async(RefDense.from_problem(ref_problem),
                                    rcfg, ticks=4, **kw)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_streams_are_the_references(name, ref_problem, problem, tmp_path):
    """Record counts and field sets equal, stream by stream."""
    kw = _engine_kw(name)
    _, want = _ref_session(lambda: _run_ref(name, ref_problem,
                                            RefConfig(**kw)), tmp_path)
    _, got = _port_session(lambda: _run_port(name, problem, GFLConfig(**kw)),
                           tmp_path)
    assert sorted(got) == sorted(want)
    for stream in want:
        assert len(got[stream]) == len(want[stream]), stream
        assert [sorted(r) for r in got[stream]] == \
            [sorted(r) for r in want[stream]], stream
    assert "round" in got and "privacy" in got
    # the round stream's engine tag and index
    assert [r["round"] for r in got["round"]] == list(range(4))


@pytest.mark.parametrize("name", list(ENGINE_CASES))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_on_and_off_are_bitwise_the_plain_run(name, use_kernels, problem,
                                              tmp_path):
    plain = _run_port(name, problem, GFLConfig(**_engine_kw(
        name, "off", use_kernels)))
    on, _ = _port_session(lambda: _run_port(name, problem, GFLConfig(
        **_engine_kw(name, "memory", use_kernels))), tmp_path)
    a = plain if isinstance(plain, tuple) else (plain.msd, plain.params)
    b = on if isinstance(on, tuple) else (on.msd, on.params)
    assert a[0].tolist() == b[0].tolist()
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_step_norms_equal_the_reference(use_kernels, ref_problem, problem,
                                        tmp_path, monkeypatch):
    """The dense loop's step stream (update and param norms) with the
    reference's draws replayed, at atol 1e-5."""
    kw = _engine_kw("dense", use_kernels=use_kernels)
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    if use_kernels:
        jax.clear_caches()
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "ref")
    try:
        _, want = _ref_session(lambda: ref_run_gfl(
            ref_problem, rcfg, iters=4, batch_size=5, seed=3), tmp_path)
    finally:
        if use_kernels:
            monkeypatch.delenv("REPRO_KERNEL_BACKEND")
            jax.clear_caches()
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K, N, M, iters=4,
                                      batch_size=5, seed=3), device="cpu")
    _, got = _port_session(lambda: run_gfl(problem, tcfg, iters=4,
                                           batch_size=5, draws=draws),
                           tmp_path)
    assert draws.remaining == 0
    assert [r["step"] for r in got["step"]] == \
        [r["step"] for r in want["step"]] == [1, 2, 3, 4]
    for field in ("update_norm", "param_norm"):
        np.testing.assert_allclose([r[field] for r in got["step"]],
                                   [r[field] for r in want["step"]],
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose([r["msd"] for r in got["round"]],
                               [r["msd"] for r in want["round"]],
                               atol=1e-5, rtol=0)
    for field in ("eps", "eps_release_amp", "q", "delta"):
        np.testing.assert_allclose([r[field] for r in got["privacy"]],
                                   [r[field] for r in want["privacy"]],
                                   rtol=1e-6)


def test_scan_step_msd_equals_the_reference(ref_problem, problem, tmp_path):
    kw = _engine_kw("population_scan")
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    _, want = _ref_session(lambda: ref_pop_engine.run_gfl_population(
        RefDense.from_problem(ref_problem), rcfg, iters=4, batch_size=5,
        seed=3, scan=True), tmp_path)
    draws = ReplayDraws(run_gfl_draws(rcfg, P, K, N, M, iters=4,
                                      batch_size=5, seed=3), device="cpu")
    _, got = _port_session(lambda: run_gfl_population(
        DensePopulation.from_problem(problem), tcfg, iters=4, batch_size=5,
        scan=True, draws=draws), tmp_path)
    assert [r["step"] for r in got["step"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["msd"] for r in got["step"]],
                               [r["msd"] for r in want["step"]],
                               atol=1e-5, rtol=0)


def test_event_scan_step_stream_equals_the_reference(ref_problem, problem,
                                                     tmp_path):
    kw = _engine_kw("events_scan")
    rcfg, tcfg = RefConfig(**kw), GFLConfig(**kw)
    _, want = _ref_session(lambda: ref_events.run_gfl_async(
        RefDense.from_problem(ref_problem), rcfg, ticks=4, batch_size=5,
        seed=3, scan=True), tmp_path)
    draws = ReplayDraws(async_run_draws(rcfg, ticks=4, batch_size=5, seed=3,
                                        D=M), device="cpu")
    _, got = _port_session(lambda: run_gfl_async(
        problem, tcfg, ticks=4, batch_size=5, scan=True, draws=draws),
        tmp_path)
    for field in ("step", "flushed", "events", "events_total", "dropped"):
        assert [r[field] for r in got["step"]] == \
            [r[field] for r in want["step"]], field
    for field in ("msd", "staleness"):
        np.testing.assert_allclose([r[field] for r in got["step"]],
                                   [r[field] for r in want["step"]],
                                   atol=1e-5, rtol=0)


# -------------------------------------------------------- inspector CLI

def _run_inspect(args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.inspect"] + args,
        cwd=REPO_ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "HOME": "/tmp"})


def test_inspector_cli_on_engine_output(tmp_path):
    jl = tmp_path / "run.jsonl"
    trace = tmp_path / "run.trace.json"
    with session(f"jsonl:{jl}", trace_path=trace):
        run_gfl_population(_synthetic(), _pop_cfg("hybrid",
                                                  telemetry="jsonl"),
                           iters=3, batch_size=5, seed=0, scan=True)
    proc = _run_inspect([str(jl), "--trace", str(trace), "--tail", "2"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "privacy" in proc.stdout and "eps" in proc.stdout
    assert "valid Chrome trace" in proc.stdout
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"population_run", "population_scan",
            "privacy_accounting"} <= names


def test_inspector_cli_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"stream": "round", "bogus_field": 3}\nnot json\n')
    proc = _run_inspect([str(bad)])
    assert proc.returncode == 1


def test_inspector_bench_reads_history_and_writes_nothing():
    before = sorted(p.name for p in REPO_ROOT.iterdir())
    history = REPO_ROOT / "BENCH_history.jsonl"
    size = history.stat().st_size
    proc = _run_inspect(["bench", str(history), "--last", "5"])
    assert proc.returncode == 0, proc.stderr
    assert "history entries" in proc.stdout
    assert sorted(p.name for p in REPO_ROOT.iterdir()) == before
    assert history.stat().st_size == size
