"""Fleet coordinator: namebook owner, cohort dispatcher, failure detector
(port of ``repro.core.fleet.coordinator``).

The coordinator process owns the :class:`~repro_torch.core.fleet.namebook.
Namebook` and drives the protocol tick by tick (the TF
``ClusterCoordinator`` schedule-and-retry pattern over the DGL
``KVServer`` membership model):

1. realize the tick's chaos plan (SIGKILL / abrupt-halt injections);
2. draw every server's cohort from the shared deterministic fault-stream
   rng (``STREAM_ARRIVAL``) — realizations are pure in ``(seed, tick)``
   so faulted and unfaulted runs dispatch identical cohorts;
3. dispatch ``(tick, w_p, cohort)`` to each live worker and collect
   replies with per-attempt timeout, bounded retry and exponential
   backoff (``FleetSpec``); a worker that exhausts the budget is marked
   lost in the namebook, its links are folded out of the combination
   matrix for the tick (``fold_dropped_links`` — the same repaired
   effective A_i the simulated resilience runtime uses), and an elastic
   restart is launched from its last checkpoint;
4. fold the replies — deduped per tick (first reply wins) and per
   ``(server, version)`` (a re-delivered flush is charged exactly once) —
   run the eq.-8 graph combine when anyone flushed, and emit the tick's
   ``fleet`` telemetry record (heartbeat ages, retries, restarts, replay
   lag, down servers).

On the port the coordinator keeps the model ``w`` and the cached psi as
[P, dim] float32 tensors on its device.  The repaired matrix is numpy on
the host, and the combine is K3 ``graph_combine`` (``ops.graph_combine``,
``g=None``; its plain version on the CPU).  A tick reads ``w`` to the host
once, for the dispatch, and the MSD once.  :class:`Fleet` builds the
kernels once, before it spawns a worker, so spawned workers only load
them; it spawns with the ``spawn`` context only (CUDA cannot fork).

Privacy accounting is worker-authoritative: each worker's q-ledger rides
its checkpoints and its ``bye`` message; the coordinator also records the
``(flushed, q)`` schedule it OBSERVED, and the two agree whenever every
flush reply was collected (the chaos tests pin this).
"""
from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.fleet.namebook import (COORDINATOR, Namebook,
                                             WorkerEntry, worker_name)
from repro_torch.core.fleet.spec import FleetSpec, parse_fleet_spec
from repro_torch.core.fleet.transport import (InprocHub, Message,
                                              make_transport, pack_array,
                                              send_with_retry, unpack_array)
from repro_torch.core.fleet.worker import (WORKER_KERNELS, FleetProblem,
                                           FleetWorker, client_shard,
                                           logistic_grad,
                                           worker_process_main)
from repro_torch.core.resilience.faults import (STREAM_ARRIVAL,
                                                fault_stream_rng)
from repro_torch.core.resilience.process import fold_dropped_links
from repro_torch.kernels import ops

#: every kernel of a fleet run: the workers' K1 + K2, the coordinator's K3
FLEET_KERNELS = (*WORKER_KERNELS, "graph_combine")


@dataclass
class FleetRunResult:
    """One fleet run's trajectory and resilience ledger."""
    msd: np.ndarray                 # [T] centroid MSD vs w_ref
    params: torch.Tensor            # final [P, D] float32, on the device
    flushed: np.ndarray             # [T, P] observed release schedule
    q: np.ndarray                   # [T, P] observed per-flush rates
    versions: np.ndarray            # [P] final flush counts
    q_ledgers: List[list]           # per-server worker-authoritative ledger
    retries: int = 0
    restarts: int = 0
    kills: int = 0
    recovery_s: List[float] = field(default_factory=list)  # loss->rejoin
    ticks_per_s: float = 0.0

    @property
    def releases(self) -> np.ndarray:
        return self.flushed.sum(axis=0)


def reference_solution(prob: FleetProblem, iters: int = 3000,
                       lr: float = 0.5) -> np.ndarray:
    """w_ref: full-batch GD on the pooled fleet population (numpy float64,
    bit for bit the reference's)."""
    hs, gs = [], []
    for p in range(prob.P):
        for k in range(prob.K):
            h, g = client_shard(prob, p, k)
            hs.append(h)
            gs.append(g)
    h = np.concatenate(hs)
    g = np.concatenate(gs)
    w = np.zeros(prob.dim)
    for _ in range(iters):
        w = w - lr * logistic_grad(w, h, g, prob.rho)
    return w


def fleet_cohort(prob: FleetProblem, tick: int) -> np.ndarray:
    """[P, E] cohort draw of the tick — the shared fault-stream rng
    discipline, pure in ``(seed, tick)`` and independent of fleet state
    (a chaos run and its unfaulted twin dispatch identical cohorts)."""
    rng = fault_stream_rng(prob.seed, STREAM_ARRIVAL, tick)
    return np.stack([rng.choice(prob.K, prob.events, replace=False)
                     for _ in range(prob.P)])


class Fleet:
    """Worker lifecycle across the three transport realizations.

    inproc workers are threads sharing an :class:`InprocHub` and the
    coordinator's device, each on a stream of its own (a "kill" is an
    abrupt halt flag — no checkpoint, no goodbye — the tier-1-safe SIGKILL
    twin); filelog and socket workers are spawned OS processes, each with
    its own CUDA context on a card, and a kill is a real ``SIGKILL``.
    """

    def __init__(self, prob: FleetProblem, spec: FleetSpec, ckpt_root: str,
                 *, device=None):
        self.prob = prob
        self.spec = spec
        self.ckpt_root = ckpt_root
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # once, before any worker exists: workers only load the
            # libraries, so no two processes race nvcc under the hello
            # deadline
            from repro_torch.kernels import _build
            _build.build(FLEET_KERNELS)
        self.hub = InprocHub() if spec.transport == "inproc" else None
        self.log_root = (os.path.join(ckpt_root, "logs")
                         if spec.transport == "filelog" else None)
        self.addresses: Optional[dict] = ({} if spec.transport == "socket"
                                          else None)
        self._members: Dict[int, object] = {}   # p -> thread | Process
        self._inproc_workers: Dict[int, FleetWorker] = {}
        self.coordinator_transport = make_transport(
            spec, COORDINATOR, hub=self.hub, root=self.log_root,
            addresses=self.addresses, replay=False)

    def ckpt_dir(self, p: int) -> str:
        return os.path.join(self.ckpt_root, worker_name(p))

    def spawn(self, p: int) -> None:
        """Start (or elastically restart) server ``p``'s worker from its
        checkpoint directory."""
        if self.spec.transport == "inproc":
            transport = make_transport(self.spec, worker_name(p),
                                       hub=self.hub)
            w = FleetWorker(p, self.prob, self.spec, transport,
                            self.ckpt_dir(p), device=self.device)
            t = threading.Thread(target=w.run, daemon=True,
                                 name=f"fleet-{worker_name(p)}")
            t.start()
            self._inproc_workers[p] = w
            self._members[p] = t
            return
        import multiprocessing as mp
        ctx = mp.get_context("spawn")    # a CUDA context cannot fork
        coord_addr = (self.addresses[COORDINATOR]
                      if self.addresses is not None else None)
        proc = ctx.Process(
            target=worker_process_main,
            args=(p, self.prob.to_dict(), self.spec.to_spec(),
                  self.ckpt_dir(p), self.spec.transport, self.log_root,
                  coord_addr, str(self.device)),
            daemon=True, name=f"fleet-{worker_name(p)}")
        proc.start()
        self._members[p] = proc

    def spawn_all(self) -> None:
        for p in range(self.prob.P):
            self.spawn(p)

    def kill(self, p: int) -> None:
        """The ``outage ... kill`` realization: SIGKILL the worker process
        (abrupt-halt flag for inproc threads) — no checkpoint, no
        goodbye."""
        member = self._members.get(p)
        if member is None:
            return
        if self.spec.transport == "inproc":
            self._inproc_workers[p].kill_flag.set()
            member.join(timeout=5.0)
        else:
            if member.pid is not None:
                try:
                    os.kill(member.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            member.join(timeout=5.0)

    def shutdown(self) -> None:
        """Stop every member: join, then terminate and at last SIGKILL a
        process that does not end, and reap it."""
        for p in list(self._members):
            member = self._members.pop(p)
            if self.spec.transport == "inproc":
                self._inproc_workers[p].kill_flag.set()
            member.join(timeout=2.0)
            if self.spec.transport != "inproc" and member.is_alive():
                member.terminate()
                member.join(timeout=5.0)
                if member.is_alive():
                    member.kill()
                    member.join()
        self.coordinator_transport.close()


class Coordinator:
    """The dispatch / collect / repair / combine loop."""

    def __init__(self, fleet: Fleet, *, A: Optional[np.ndarray] = None,
                 w_ref: Optional[np.ndarray] = None,
                 kill_at: Optional[Dict[int, list]] = None,
                 await_rejoin: bool = False):
        from repro_torch.core.topology import combination_matrix
        self.fleet = fleet
        self.prob = fleet.prob
        self.spec = fleet.spec
        self.device = fleet.device
        self.transport = fleet.coordinator_transport
        self.namebook = Namebook(self.prob.P)
        self.A = (np.asarray(A, np.float64) if A is not None
                  else combination_matrix("ring", self.prob.P))
        self.w_ref = (w_ref if w_ref is not None
                      else reference_solution(self.prob))
        self.kill_at = dict(kill_at or {})
        # barrier-on-rejoin: block the next dispatch until every killed
        # worker's elastic restart has said hello.  Off by default (the
        # fleet degrades to the repaired topology and the straggler
        # rejoins whenever it is back); on for chaos runs that pin
        # EXACT recovery — a process restart costs seconds while ticks
        # cost milliseconds, so without the barrier a short run can end
        # before the rejoin lands.
        self.await_rejoin = await_rejoin
        shape = (self.prob.P, self.prob.dim)
        self.w = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.psi_cache = torch.zeros_like(self.w)
        self._w_host = np.zeros(shape, np.float32)   # w as dispatched
        self._w_ref = torch.as_tensor(np.asarray(self.w_ref, np.float64),
                                      device=self.device)
        self._A_eff: Dict[tuple, torch.Tensor] = {}  # down set -> A_eff
        self.q_ledgers: Dict[int, list] = {}
        self.kills = 0
        self.recovery_s: List[float] = []
        self._lost_at: Dict[int, float] = {}

    # ------------------------------------------------------------ inbound

    def _handle_admin(self, msg: Message) -> None:
        """Track hellos / heartbeats / byes in the namebook."""
        nb = self.namebook
        if msg.kind == "hello":
            addr = msg.payload.get("address") or None
            e = nb.hello(msg.sender, address=addr,
                         pid=msg.payload.get("pid"),
                         tick_done=int(msg.payload.get("tick_done", -1)),
                         version=msg.version)
            if self.fleet.addresses is not None and addr:
                self.fleet.addresses[msg.sender] = tuple(addr)
            lost = self._lost_at.pop(e.server, None)
            if lost is not None:
                self.recovery_s.append(time.monotonic() - lost)
        elif msg.kind == "heartbeat":
            nb.heartbeat(msg.sender)
        elif msg.kind == "bye":
            e = nb.entry(msg.sender)
            self.q_ledgers[e.server] = list(msg.payload.get("q_history", []))
            nb.mark_lost(msg.sender)

    def _await_hellos(self, deadline_s: float = 30.0) -> None:
        """Block until every worker has said hello once."""
        deadline = time.monotonic() + deadline_s
        while len(self.namebook.live_servers()) < self.prob.P:
            msg = self.transport.recv(timeout=0.1)
            if msg is not None:
                self._handle_admin(msg)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet failed to assemble: live="
                    f"{self.namebook.live_servers()} of P={self.prob.P}")

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, p: int, tick: int, cohort: np.ndarray) -> bool:
        e = self.namebook.by_server(p)
        msg = Message("cohort", COORDINATOR, tick, {
            "tick": tick, "w": pack_array(self._w_host[p]),
            "cohort": [int(k) for k in cohort[p]]})
        return send_with_retry(
            self.transport, e.name, msg, self.spec,
            on_retry=lambda a: self._count_retry(e))

    @staticmethod
    def _count_retry(e: WorkerEntry) -> None:
        e.retries += 1

    def _collect(self, tick: int, cohort: np.ndarray,
                 expect: set) -> Dict[int, dict]:
        """Replies for ``tick`` from ``expect``, with retry + backoff;
        servers still missing after the budget are marked lost (and
        elastically restarted)."""
        replies: Dict[int, dict] = {}
        nb = self.namebook
        for attempt in range(1 + self.spec.retry):
            deadline = time.monotonic() + self.spec.timeout
            while replies.keys() < expect and time.monotonic() < deadline:
                msg = self.transport.recv(timeout=0.05)
                if msg is None:
                    continue
                if msg.kind != "psi":
                    self._handle_admin(msg)
                    if msg.kind == "hello":
                        # elastic rejoin mid-collect: fold it back in NOW
                        p = nb.entry(msg.sender).server
                        if p not in replies and self._dispatch(p, tick,
                                                               cohort):
                            expect.add(p)
                    continue
                e = nb.entry(msg.sender)
                nb.heartbeat(msg.sender)
                payload = msg.payload
                if int(payload.get("tick", -1)) != tick:
                    continue              # stale straggler reply: dropped
                if e.server in replies:
                    continue              # duplicate delivery this tick
                if payload.get("flushed") and not nb.record_reply(
                        e.server, msg.version):
                    # replayed flush we already folded under an earlier
                    # tick: treat as a cached announcement, charge nothing
                    payload = dict(payload, flushed=0, q=0.0)
                e.tick_done = tick
                e.version = max(e.version, msg.version)
                replies[e.server] = payload
            missing = expect - replies.keys()
            if not missing:
                return replies
            if attempt < self.spec.retry:
                time.sleep(min(self.spec.backoff_delay(attempt), 2.0))
                for p in sorted(missing):
                    e = nb.by_server(p)
                    e.retries += 1
                    self._dispatch(p, tick, cohort)
        for p in sorted(expect - replies.keys()):
            # loss: elastic restart from the checkpoint; the restarted
            # worker's hello bumps the namebook restart count
            nb.mark_lost(worker_name(p))
            self._lost_at[p] = time.monotonic()
            self.fleet.spawn(p)
        return replies

    # ------------------------------------------------------------ combine

    def _psi(self, replies: Dict[int, dict]) -> torch.Tensor:
        """[P, dim] psi of the tick: the replies' rows, one copy to the
        device, over the cached psi of the servers that sent none."""
        if not replies:
            return self.psi_cache
        rows = sorted(replies)
        fresh = torch.from_numpy(np.stack(
            [unpack_array(replies[p]["psi"]) for p in rows]
        ).astype(np.float32)).to(self.device)
        if len(rows) == self.prob.P:
            return fresh
        index = torch.tensor(rows, device=self.device)
        return self.psi_cache.index_copy(0, index, fresh)

    def _repaired_A(self, down: list) -> torch.Tensor:
        """The tick's effective A on the device: a down server keeps only
        its self-loop, its lost link mass folds back into the surviving
        endpoints' diagonals (Metropolis).  Built on the host once a down
        set; with none down it is ``A`` bit for bit."""
        key = tuple(down)
        A_eff = self._A_eff.get(key)
        if A_eff is None:
            P = self.prob.P
            mask = ~np.eye(P, dtype=bool) & (self.A > 0)
            if down:
                mask[down, :] = False
                mask[:, down] = False
            A_eff = torch.from_numpy(fold_dropped_links(self.A, mask)
                                     .astype(np.float32)).to(self.device)
            self._A_eff[key] = A_eff
        return A_eff

    # ------------------------------------------------------------ the loop

    def run(self, ticks: int) -> FleetRunResult:
        from repro_torch.telemetry import emit, telemetry_active
        self.fleet.spawn_all()
        self._await_hellos()
        P, T = self.prob.P, ticks
        msd = np.zeros(T)
        flushed = np.zeros((T, P), bool)
        q = np.zeros((T, P))
        t0 = time.monotonic()
        for t in range(T):
            for p in self.kill_at.pop(t, []):
                self.fleet.kill(p)
                self.namebook.mark_lost(worker_name(p))
                self._lost_at[p] = time.monotonic()
                self.kills += 1
                self.fleet.spawn(p)       # elastic restart begins at once
            if self.await_rejoin and self._lost_at:
                self._await_rejoins()
            cohort = fleet_cohort(self.prob, t)
            self._w_host = self.w.cpu().numpy()
            expect = set()
            for p in self.namebook.live_servers():
                if self._dispatch(p, t, cohort):
                    expect.add(p)
                else:
                    self.namebook.mark_lost(worker_name(p))
                    self._lost_at[p] = time.monotonic()
                    self.fleet.spawn(p)
            replies = self._collect(t, cohort, expect)

            for p, payload in replies.items():
                flushed[t, p] = bool(payload["flushed"])
                q[t, p] = float(payload["q"])
            psi = self._psi(replies)
            down = sorted(set(range(P)) - replies.keys())
            if flushed[t].any():
                # eq. 8 over the repaired topology, through K3
                self.w = ops.graph_combine(self._repaired_A(down), psi)
            self.psi_cache = psi
            centroid = self.w.to(torch.float64).mean(dim=0)
            msd[t] = float(((centroid - self._w_ref) ** 2).sum())

            if telemetry_active():
                total_retries, total_restarts = self.namebook.totals()
                emit("fleet", {
                    "tick": t,
                    "heartbeat_age": [
                        min(a, 1e6) for a in self.namebook.heartbeat_ages()],
                    "retries": total_retries,
                    "restarts": total_restarts,
                    "replay_lag": int(self.transport.stats().get(
                        "replay_lag", 0)),
                    "down": [int(p in down) for p in range(P)],
                    "flushes": int(flushed[t].sum()),
                    "msd": msd[t],
                })
        wall = max(time.monotonic() - t0, 1e-9)
        self._stop_workers()
        total_retries, total_restarts = self.namebook.totals()
        return FleetRunResult(
            msd=msd, params=self.w.clone(), flushed=flushed, q=q,
            versions=np.asarray([self.namebook.by_server(p).version
                                 for p in range(P)]),
            q_ledgers=[self.q_ledgers.get(p, []) for p in range(P)],
            retries=total_retries, restarts=total_restarts,
            kills=self.kills, recovery_s=list(self.recovery_s),
            ticks_per_s=T / wall)

    def _await_rejoins(self, deadline_s: float = 60.0) -> None:
        """Barrier-on-rejoin: drain admin traffic until every restarted
        worker has said hello (or the deadline passes — then the tick
        proceeds on the repaired topology as usual)."""
        deadline = time.monotonic() + deadline_s
        while self._lost_at and time.monotonic() < deadline:
            msg = self.transport.recv(timeout=0.1)
            if msg is not None and msg.kind != "psi":
                self._handle_admin(msg)

    def _stop_workers(self) -> None:
        """Graceful drain: stop every live worker, harvest bye ledgers."""
        live = set(self.namebook.live_servers())
        for p in sorted(live):
            send_with_retry(self.transport, worker_name(p),
                            Message("stop", COORDINATOR, 0, {}), self.spec)
        deadline = time.monotonic() + max(2.0, self.spec.timeout)
        while live - set(self.q_ledgers) and time.monotonic() < deadline:
            msg = self.transport.recv(timeout=0.1)
            if msg is not None:
                self._handle_admin(msg)
        self.fleet.shutdown()


def run_fleet(prob: FleetProblem, spec: "FleetSpec | str", ticks: int, *,
              ckpt_root: str, A: Optional[np.ndarray] = None,
              w_ref: Optional[np.ndarray] = None,
              kill_at: Optional[Dict[int, list]] = None,
              await_rejoin: bool = False, device=None) -> FleetRunResult:
    """Assemble a fleet, run ``ticks`` protocol ticks, tear it down.  Runs
    on ``cuda`` unless ``device`` says otherwise."""
    if isinstance(spec, str):
        spec = parse_fleet_spec(spec)
    fleet = Fleet(prob, spec, ckpt_root, device=device)
    coord = Coordinator(fleet, A=A, w_ref=w_ref, kill_at=kill_at,
                        await_rejoin=await_rejoin)
    try:
        return coord.run(ticks)
    finally:
        fleet.shutdown()
