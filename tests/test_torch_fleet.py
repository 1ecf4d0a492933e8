"""The port's fleet (``repro_torch.core.fleet``) against ``repro.core.fleet``,
on the CPU at small sizes.

Exact: the copies — ``client_shard``, ``flush_noise``, ``fleet_cohort``,
``reference_solution``, ``plan_kills``, ``Message.encode`` bytes, the
filelog replay, the namebook's dedup — and every integer outcome of a run
(flush schedule, q, versions, q-ledgers, the ``fleet`` stream's counters).
The port's state is float32 on the device where the reference's is
float64 numpy, so values match within a tolerance: a worker's psi within
atol 1e-6 over a sequence of ticks, a whole run's MSD within rtol 1e-5
and its params within atol 1e-5.  A killed-and-restored run is bitwise its
clean twin (``msd_gap == 0.0``), as the reference's chaos test holds.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core.fleet import coordinator as ref_coord
from repro.core.fleet import transport as ref_transport
from repro.core.fleet import worker as ref_worker
from repro.telemetry import session as ref_session
from repro_torch.core import fleet
from repro_torch.core.fleet import coordinator, transport, worker
from repro_torch.telemetry import session
from repro_torch.telemetry.watch import main as watch_main

# (P, K, n, buffer, events, sigma_g, seed); one noiseless
PROBLEMS = [
    dict(P=3, K=12, n=10, buffer=4, events=3, sigma_g=0.3, seed=11),
    dict(P=4, K=16, n=12, buffer=6, events=4, sigma_g=0.2, seed=3),
    dict(P=5, K=10, n=8, dim=3, buffer=7, events=5, sigma_g=0.0, seed=2,
         data_seed=4, grad_bound=0.5),
]
TICKS = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the run's ops are tiny, and torch's pool
    slows by orders of magnitude when other test processes hold the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probs(kw):
    return ref_worker.FleetProblem(**kw), worker.FleetProblem(**kw)


def _params(result) -> np.ndarray:
    return result.params.cpu().numpy()


# ------------------------------------------------------------- the copies


def test_exports_are_the_references():
    assert sorted(fleet.__all__) == sorted(ref_fleet.__all__)
    assert len(fleet.__all__) == 29
    for name in fleet.__all__:
        assert hasattr(fleet, name), name


@pytest.mark.parametrize("kw", PROBLEMS, ids=("p3", "p4", "p5"))
def test_shards_noise_and_cohorts_bit_equal(kw):
    ref, port = _probs(kw)
    assert port.to_dict() == ref.to_dict()
    assert worker.FleetProblem.from_dict(ref.to_dict()) == port
    for p in range(ref.P):
        for k in range(ref.K):
            rh, rg = ref_worker.client_shard(ref, p, k)
            ph, pg = worker.client_shard(port, p, k)
            np.testing.assert_array_equal(ph, rh)
            np.testing.assert_array_equal(pg, rg)
        for version in range(1, 6):
            np.testing.assert_array_equal(
                worker.flush_noise(port, p, version),
                ref_worker.flush_noise(ref, p, version))
    for tick in range(12):
        np.testing.assert_array_equal(coordinator.fleet_cohort(port, tick),
                                      ref_coord.fleet_cohort(ref, tick))


@pytest.mark.parametrize("kw", PROBLEMS, ids=("p3", "p4", "p5"))
def test_reference_solution_bit_equal(kw):
    ref, port = _probs(kw)
    np.testing.assert_array_equal(coordinator.reference_solution(port),
                                  ref_coord.reference_solution(ref))


def test_numpy_grad_and_clip_bit_equal():
    rng = np.random.default_rng(0)
    h, gamma = rng.normal(size=(9, 3)), np.sign(rng.normal(size=9))
    w = rng.normal(size=3) * 30.0          # margins past the +-50 clip
    np.testing.assert_array_equal(worker.logistic_grad(w, h, gamma, 0.01),
                                  ref_worker.logistic_grad(w, h, gamma, 0.01))
    for bound in (0.0, 0.1, 100.0):
        np.testing.assert_array_equal(worker.clip_to_bound(w, bound),
                                      ref_worker.clip_to_bound(w, bound))


@pytest.mark.parametrize("spec", ["outage:0.3,kill=1", "outage:0.5,kill=1",
                                  "outage:0.9,kill=1",
                                  "links:0.1+outage:0.2,kill=1",
                                  "outage:0.5", "none"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_plan_kills_bit_equal(spec, seed):
    for P in (2, 4, 6):
        assert fleet.plan_kills(spec, P, 20, seed=seed) == \
            ref_fleet.plan_kills(spec, P, 20, seed=seed)
        assert fleet.plan_kills(spec, P, 20, seed=seed, max_down=1) == \
            ref_fleet.plan_kills(spec, P, 20, seed=seed, max_down=1)


def test_message_bytes_equal_the_references():
    psi32 = torch.tensor([1.5, -2.25e-3, 0.1, 3.0e7], dtype=torch.float32)
    envelopes = [
        ("psi", "worker1", 4, {"tick": 3, "psi": None, "flushed": 1,
                               "q": 0.375}),
        ("cohort", "coordinator", 9, {"tick": 9, "w": None,
                                      "cohort": [3, 0, 7]}),
        ("hello", "worker0", 0, {"tick_done": -1, "pid": 42,
                                 "address": ["127.0.0.1", 5000]}),
        ("stop", "coordinator", 0, {}),
    ]
    for kind, sender, version, payload in envelopes:
        port_payload, ref_payload = dict(payload), dict(payload)
        for key in ("psi", "w"):
            if key in payload:
                port_payload[key] = transport.pack_array(psi32.numpy())
                ref_payload[key] = ref_transport.pack_array(
                    psi32.numpy().astype(np.float64))
        port_msg = transport.Message(kind, sender, version, port_payload)
        ref_msg = ref_transport.Message(kind, sender, version, ref_payload)
        assert port_msg.encode() == ref_msg.encode()
        back = transport.Message.decode(ref_msg.encode())
        assert back == port_msg
    # float32 rides the float64 wire exactly
    got = transport.unpack_array(transport.pack_array(psi32.numpy()))
    assert np.array_equal(got.astype(np.float32), psi32.numpy())


def test_filelog_transport_replay_and_lag(tmp_path):
    root = str(tmp_path)
    a = transport.FileLogTransport(root, "a")
    b = transport.FileLogTransport(root, "b")
    for v in range(3):
        a.send("b", transport.Message("psi", "a", v, {"v": v}))
    got = [b.recv(timeout=1.0) for _ in range(3)]
    assert [m.version for m in got] == [0, 1, 2]
    assert b.recv(timeout=0.05) is None
    # a torn trailing line (crashed writer mid-append) is tolerated
    with open(os.path.join(root, "b.log"), "a") as fh:
        fh.write('{"kind": "psi", "sen')
    assert b.recv(timeout=0.05) is None
    # a fresh endpoint replays from offset 0: full backlog shows as lag
    b2 = transport.FileLogTransport(root, "b", replay=True)
    assert b2.stats()["replay_lag"] == 3
    # the reference's endpoint reads the port's log the same way
    b3 = ref_transport.FileLogTransport(root, "b", replay=True)
    assert b3.stats()["replay_lag"] == 3
    assert [b3.recv(timeout=1.0).version for _ in range(3)] == [0, 1, 2]
    tail = transport.FileLogTransport(root, "b", replay=False)
    assert tail.recv(timeout=0.05) is None
    for t in (a, b, b2, b3, tail):
        t.close()


def test_namebook_dedup_and_membership():
    nb = fleet.Namebook(3)
    assert nb.record_reply(1, 1) is True
    assert nb.record_reply(1, 1) is False        # re-delivered flush
    assert nb.record_reply(1, 2) is True
    assert nb.record_reply(2, 1) is True
    assert nb.live_servers() == []
    nb.hello("worker0", pid=7, tick_done=-1, version=0)
    nb.hello("worker2", address=("127.0.0.1", 9), version=3)
    assert nb.live_servers() == [0, 2] and nb.down_servers() == [1]
    assert nb.by_server(2).address == ("127.0.0.1", 9)
    nb.mark_lost("worker0")
    nb.hello("worker0", pid=8)                   # elastic restart
    assert nb.totals() == (0, 1)
    ages = nb.heartbeat_ages()
    assert ages[1] == float("inf") and ages[0] < 60.0
    assert fleet.worker_name(4) == ref_fleet.worker_name(4)
    assert fleet.COORDINATOR == ref_fleet.COORDINATOR


# ---------------------------------------------------------------- the worker


@pytest.mark.parametrize("kw", PROBLEMS, ids=("p3", "p4", "p5"))
def test_worker_tick_parity(tmp_path, kw):
    ref, port = _probs(kw)
    spec = fleet.parse_fleet_spec("fleet")
    ref_spec = ref_fleet.parse_fleet_spec("fleet")
    p = ref.P - 1
    rw = ref_worker.FleetWorker(
        p, ref, ref_spec, ref_transport.InprocHub().register("w"),
        str(tmp_path / "ref"))
    pw = worker.FleetWorker(p, port, spec,
                            transport.InprocHub().register("w"),
                            str(tmp_path / "port"), device="cpu")
    rng = np.random.default_rng(5)
    flushes = 0
    for tick in range(10):
        w = rng.normal(size=port.dim).astype(np.float32).astype(np.float64)
        cohort = [int(k) for k in coordinator.fleet_cohort(port, tick)[p]]
        want = rw.compute_tick(tick, w, cohort)
        got = pw.compute_tick(tick, w, cohort)
        assert (got["tick"], got["flushed"], got["q"]) == \
            (want["tick"], want["flushed"], want["q"])
        assert pw.version == rw.version and pw.buf_n == rw.buf_n
        assert pw.q_history == rw.q_history
        np.testing.assert_allclose(got["psi"], want["psi"], rtol=0,
                                   atol=1e-6)
        flushes += got["flushed"]
    assert flushes >= 2
    # an empty cohort folds nothing
    before = (pw.buf_n, pw.buf_wsum, pw.buf_sum.clone())
    pw.compute_tick(10, np.zeros(port.dim), [])
    assert (pw.buf_n, pw.buf_wsum) == before[:2]
    assert torch.equal(pw.buf_sum, before[2])


def test_cohort_grads_match_the_numpy_gradient():
    prob = worker.FleetProblem(P=2, K=6, n=9, dim=3)
    H, gamma = worker.client_shards(prob, 1, "cpu")
    rng = np.random.default_rng(2)
    w = rng.normal(size=3).astype(np.float32)
    got = worker.cohort_grads(H[[4, 0]], gamma[[4, 0]], torch.from_numpy(w),
                              prob.rho)
    for row, k in zip(got, (4, 0)):
        h, g = worker.client_shard(prob, 1, k)
        want = worker.logistic_grad(w.astype(np.float64), h, g, prob.rho)
        np.testing.assert_allclose(row.numpy(), want, rtol=0, atol=1e-6)


# -------------------------------------------------------------- whole runs


def _runs(tmp_path, kw, ticks=TICKS, **extra):
    ref, port = _probs(kw)
    want = ref_fleet.run_fleet(ref, "fleet:timeout=2", ticks,
                               ckpt_root=str(tmp_path / "ref"), **extra)
    got = fleet.run_fleet(port, "fleet:timeout=2", ticks,
                          ckpt_root=str(tmp_path / "port"), device="cpu",
                          **extra)
    return want, got


def _require_parity(want, got):
    np.testing.assert_array_equal(got.flushed, want.flushed)
    np.testing.assert_array_equal(got.q, want.q)
    np.testing.assert_array_equal(got.versions, want.versions)
    assert got.q_ledgers == want.q_ledgers
    np.testing.assert_allclose(got.msd, want.msd, rtol=1e-5, atol=0)
    np.testing.assert_allclose(_params(got), want.params, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", PROBLEMS, ids=("p3", "p4", "p5"))
def test_run_fleet_matches_reference(tmp_path, kw):
    want, got = _runs(tmp_path, kw)
    assert want.flushed.sum() > 0
    _require_parity(want, got)
    assert got.params.dtype == torch.float32
    assert got.params.device.type == "cpu"
    assert (got.kills, got.restarts) == (want.kills, want.restarts) == (0, 0)


def test_run_fleet_on_another_topology_matches_reference(tmp_path):
    from repro_torch.core.topology import combination_matrix
    kw = PROBLEMS[1]
    A = combination_matrix("full", kw["P"])
    want, got = _runs(tmp_path, kw, A=A)
    _require_parity(want, got)


def test_degraded_tick_psi_and_repaired_matrix(tmp_path):
    """A tick with servers down: the replies' rows over the cached psi,
    and the repaired A the reference builds for that down set (as
    float32, exactly)."""
    from repro.core.resilience.process import fold_dropped_links as ref_fold
    from repro_torch.core.topology import combination_matrix
    prob = worker.FleetProblem(P=5, K=4, n=3)
    f = fleet.Fleet(prob, fleet.parse_fleet_spec("fleet"), str(tmp_path),
                    device="cpu")
    A = combination_matrix("ring", prob.P)
    coord = fleet.Coordinator(f, A=A, w_ref=np.zeros(prob.dim))
    try:
        coord.psi_cache = torch.arange(10.0).reshape(5, 2)
        replies = {p: {"psi": [float(p), -float(p)]} for p in (0, 3)}
        psi = coord._psi(replies)
        want = coord.psi_cache.clone()
        want[0] = torch.tensor([0.0, -0.0])
        want[3] = torch.tensor([3.0, -3.0])
        assert torch.equal(psi, want)
        assert coord._psi({}) is coord.psi_cache
        for down in ([], [1], [1, 2, 4]):
            mask = ~np.eye(prob.P, dtype=bool) & (A > 0)
            mask[down, :] = False
            mask[:, down] = False
            got = coord._repaired_A(down)
            assert coord._repaired_A(down) is got       # built once
            np.testing.assert_array_equal(
                got.numpy(), ref_fold(A, mask).astype(np.float32))
        np.testing.assert_array_equal(coord._repaired_A([]).numpy(),
                                      A.astype(np.float32))
    finally:
        f.shutdown()


def _ledger_epsilon(prob, qs) -> float:
    from repro_torch.core.privacy.accountant import PrivacyAccountant
    acct = PrivacyAccountant(mu=prob.mu, grad_bound=prob.grad_bound,
                             sigma_g=prob.sigma_g)
    for q in qs:
        acct.advance(1, q=float(q))
    return acct.epsilon()


def _require_exact(out):
    np.testing.assert_array_equal(out.faulted.flushed, out.clean.flushed)
    np.testing.assert_array_equal(out.faulted.q, out.clean.q)
    np.testing.assert_array_equal(out.faulted.msd, out.clean.msd)
    assert torch.equal(out.faulted.params, out.clean.params)
    assert out.faulted.q_ledgers == out.clean.q_ledgers
    assert out.msd_gap == 0.0


def test_inproc_chaos_kill_restore_is_exact(tmp_path):
    """Kill worker 1 mid-buffer at tick 2 (buffer=4, events=3: 3 folded
    arrivals pending).  Write-ahead checkpointing + idempotent dedup +
    pure (seed, tick/version) randomness make the restored run bitwise
    the never-killed twin."""
    prob = worker.FleetProblem(**PROBLEMS[0])
    out = fleet.chaos_run(prob, "fleet:timeout=2", ticks=TICKS,
                          ckpt_root=str(tmp_path), kill_at={2: [1]},
                          device="cpu")
    assert out.faulted.kills == 1
    assert out.faulted.restarts >= 1
    assert out.clean.flushed.sum() > 0
    _require_exact(out)
    assert len(out.faulted.q_ledgers) == prob.P
    for p, qs in enumerate(out.clean.q_ledgers):
        assert _ledger_epsilon(prob, out.faulted.q_ledgers[p]) == \
            _ledger_epsilon(prob, qs)
    assert _ledger_epsilon(prob, out.clean.q_ledgers[1]) > 0.0
    # and the clean twin is the reference's clean run, to tolerance
    ref = ref_worker.FleetProblem(**PROBLEMS[0])
    want = ref_fleet.run_fleet(ref, "fleet:timeout=2", TICKS,
                               ckpt_root=str(tmp_path / "ref"))
    _require_parity(want, out.clean)


def test_chaos_planned_from_an_outage_kill_spec(tmp_path):
    prob = worker.FleetProblem(**PROBLEMS[1])
    spec = "outage:0.3,kill=1"
    plan = fleet.plan_kills(spec, prob.P, TICKS, seed=prob.seed)
    assert plan, "the spec must plan at least one kill"
    out = fleet.chaos_run(prob, "fleet:timeout=2", ticks=TICKS,
                          ckpt_root=str(tmp_path), fault=spec, device="cpu")
    assert out.kill_plan == plan
    assert out.faulted.kills == sum(len(s) for s in plan.values())
    assert out.faulted.restarts == out.faulted.kills
    _require_exact(out)


# -------------------------------------------------------------- checkpoints


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    kw = PROBLEMS[1]
    _, port = _probs(kw)
    pw = worker.FleetWorker(0, port, fleet.parse_fleet_spec("fleet"),
                            transport.InprocHub().register("w"),
                            str(tmp_path / "w0"), device="cpu")
    w = np.array([0.25, -0.5])
    for tick in range(5):
        pw.last_reply = pw.compute_tick(
            tick, w, [int(k) for k in coordinator.fleet_cohort(port,
                                                               tick)[0]])
    assert pw.buf_n > 0 and pw.version > 0      # mid-buffer, after flushes
    pw.checkpoint()
    ref_state = ref_worker.load_worker_checkpoint(str(tmp_path / "w0"))
    port_state = worker.load_worker_checkpoint(str(tmp_path / "w0"))
    keys = {"params", "buf_sum", "buf_wsum", "buf_n", "version",
            "psi_cache", "tick_done", "q_history", "last_tick", "last_psi",
            "last_flushed", "last_q"}
    assert set(ref_state) == set(port_state) == keys
    for k in keys:
        np.testing.assert_array_equal(ref_state[k], port_state[k])
    np.testing.assert_array_equal(ref_state["params"], pw.params.numpy())
    np.testing.assert_array_equal(ref_state["buf_sum"], pw.buf_sum.numpy())
    assert list(ref_state["q_history"]) == pw.q_history
    assert int(ref_state["tick_done"]) == 4
    # restored onto a device, the worker's leaves are float32 tensors
    dev_state = worker.load_worker_checkpoint(str(tmp_path / "w0"),
                                              device="cpu")
    assert torch.equal(dev_state["buf_sum"], pw.buf_sum)
    assert isinstance(dev_state["buf_n"], np.ndarray)


def test_port_worker_resumes_from_a_reference_checkpoint(tmp_path):
    kw = PROBLEMS[0]
    ref, port = _probs(kw)
    p = 2
    ckpt = str(tmp_path / "w")
    rw = ref_worker.FleetWorker(p, ref, ref_fleet.parse_fleet_spec("fleet"),
                                ref_transport.InprocHub().register("w"),
                                ckpt)
    rng = np.random.default_rng(9)
    ws = [rng.normal(size=ref.dim).astype(np.float32).astype(np.float64)
          for _ in range(10)]

    def cohort(t):
        return [int(k) for k in coordinator.fleet_cohort(port, t)[p]]

    for t in range(5):
        rw.last_reply = rw.compute_tick(t, ws[t], cohort(t))
    assert rw.buf_n > 0
    rw.checkpoint()
    pw = worker.FleetWorker(p, port, fleet.parse_fleet_spec("fleet"),
                            transport.InprocHub().register("w"), ckpt,
                            device="cpu")
    assert (pw.tick_done, pw.version, pw.buf_n) == \
        (rw.tick_done, rw.version, rw.buf_n)
    assert pw.params.dtype == torch.float32
    assert pw.last_reply == rw.last_reply
    for t in range(5, 10):
        want = rw.compute_tick(t, ws[t], cohort(t))
        got = pw.compute_tick(t, ws[t], cohort(t))
        assert (got["flushed"], got["q"]) == (want["flushed"], want["q"])
        np.testing.assert_allclose(got["psi"], want["psi"], rtol=0,
                                   atol=1e-5)
    assert pw.q_history == rw.q_history


# ---------------------------------------------------------------- telemetry


def test_fleet_stream_matches_the_references(tmp_path):
    kw = PROBLEMS[0]
    ref, port = _probs(kw)
    with ref_session("memory") as rs:
        ref_fleet.chaos_run(ref, "fleet:timeout=2", ticks=TICKS,
                            ckpt_root=str(tmp_path / "ref"),
                            kill_at={2: [1]})
        want = rs.memory_records("fleet")
    with session("memory") as ps:
        fleet.chaos_run(port, "fleet:timeout=2", ticks=TICKS,
                        ckpt_root=str(tmp_path / "port"), kill_at={2: [1]},
                        device="cpu")
        got = ps.memory_records("fleet")
        kernel = ps.memory_records("kernel")
    assert len(got) == len(want) == 2 * TICKS
    for g, w in zip(got, want):
        for k in ("tick", "retries", "restarts", "down", "flushes"):
            assert g[k] == w[k], k
        assert g["msd"] == pytest.approx(w["msd"], rel=1e-5)
        assert len(g["heartbeat_age"]) == port.P
        assert isinstance(g["replay_lag"], int) and g["replay_lag"] >= 0
    assert got[-1]["restarts"] == 1
    # the workers' folds and the coordinator's combine, recorded once each
    ops = sorted(r["op"] for r in kernel)
    assert ops == ["fold_apply", "fold_norms", "graph_combine",
                   "round_fold.traffic"]


def test_watch_restart_rule_fires_on_a_killed_run(tmp_path):
    prob = worker.FleetProblem(**PROBLEMS[0])
    log = tmp_path / "fleet.jsonl"
    with session(f"jsonl:{log}"):
        out = fleet.chaos_run(prob, "fleet:timeout=2", ticks=TICKS,
                              ckpt_root=str(tmp_path / "ckpt"),
                              kill_at={2: [1], 4: [0]}, device="cpu")
    assert out.faulted.restarts == 2
    _require_exact(out)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert max(r["restarts"] for r in recs if r["stream"] == "fleet") == 2
    assert watch_main([str(log), "--rules", "restart:1", "--once"]) == 1
    assert watch_main([str(log), "--rules", "restart:2", "--once"]) == 0


# ------------------------------------------------------------ no fallback


def test_a_fleet_asked_for_cuda_without_a_card_raises(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = worker.FleetProblem(P=2, K=4, n=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.run_fleet(prob, "fleet", 2, ckpt_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.chaos_run(prob, "fleet", ticks=2, ckpt_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.FleetWorker(0, prob, fleet.parse_fleet_spec("fleet"),
                           transport.InprocHub().register("w"),
                           str(tmp_path / "w"))


# ----------------------------------------------------- spawned processes


@pytest.fixture
def _child_threads(monkeypatch):
    """Spawned workers inherit the environment: one OpenMP thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_spawned_filelog_kill_restore_is_exact(tmp_path, _child_threads):
    """Real worker processes on the filelog transport, one SIGKILLed
    mid-buffer and restarted from its checkpoint: bitwise the clean run,
    and within tolerance of the reference's inproc run."""
    kw = dict(P=2, K=8, n=6, buffer=6, events=4, sigma_g=0.2, seed=3)
    prob = worker.FleetProblem(**kw)
    t0 = time.monotonic()
    out = fleet.chaos_run(prob, "fleet:transport=filelog,timeout=5",
                          ticks=4, ckpt_root=str(tmp_path),
                          kill_at={2: [1]}, device="cpu")
    assert time.monotonic() - t0 < 60.0
    assert out.faulted.kills == 1 and out.faulted.restarts == 1
    assert len(out.faulted.recovery_s) == 1
    _require_exact(out)
    want = ref_fleet.run_fleet(ref_worker.FleetProblem(**kw),
                               "fleet:timeout=2", 4,
                               ckpt_root=str(tmp_path / "ref"))
    _require_parity(want, out.clean)


def test_a_worker_that_cannot_start_trips_the_hello_deadline(
        tmp_path, _child_threads, monkeypatch):
    """A spawned worker asked for a device it cannot reach raises before
    its hello; the coordinator's deadline reports the missing worker."""
    prob = worker.FleetProblem(P=2, K=4, n=3)
    spec = fleet.parse_fleet_spec("fleet:transport=filelog")
    f = fleet.Fleet(prob, spec, str(tmp_path), device="cpu")
    coord = fleet.Coordinator(f, w_ref=np.zeros(prob.dim))
    f.device = torch.device("cuda")     # what the children are asked for
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    try:
        f.spawn_all()
        with pytest.raises(TimeoutError, match="failed to assemble"):
            coord._await_hellos(deadline_s=6.0)
        for member in f._members.values():
            member.join(timeout=10.0)
            assert member.exitcode not in (None, 0)
    finally:
        f.shutdown()


# ------------------------------------------------- threads in one process


def test_launch_counts_and_kernel_records_survive_threads():
    """The fleet's in-process workers launch and record from several
    threads at once: no launch count and no kernel record may be lost,
    and each (op, shape) is recorded once a session.  More threads than
    cores, with a short switch interval, so a lost update would show."""
    import sys
    import threading

    from repro_torch import kernels as K
    from repro_torch.telemetry.stream import note
    threads, per = 16, 400
    saved = dict(K.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with session("memory") as sess:
            start = threading.Barrier(threads)

            def hammer(i):
                start.wait(timeout=30)
                for j in range(per):
                    K.count("fold_norms")
                    if sess.claim(("op", j % 7)):
                        note("kernel", {"seq": sess.next_seq(),
                                        "op": f"k{j % 7}"})

            pool = [threading.Thread(target=hammer, args=(i,))
                    for i in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
                assert not t.is_alive()
            recs = sess.memory_records("kernel")
            counted = K.LAUNCHES["fold_norms"] - saved["fold_norms"]
    finally:
        sys.setswitchinterval(interval)
        K.LAUNCHES.update(saved)
    assert counted == threads * per
    assert sorted(r["op"] for r in recs) == [f"k{j}" for j in range(7)]
    assert len({r["seq"] for r in recs}) == 7
    assert sess.records == 7
