"""Coordinator-owned namebook: the fleet's single membership ledger (a
copy of the reference's ``core/fleet/namebook.py``, stdlib only).

Following the DGL ``KVServer`` pattern, the coordinator is the one place
that knows who is in the fleet: every worker's name, liveness, transport
address (socket mode), last heartbeat, protocol progress (last
acknowledged tick, flush version) and restart count live in one
:class:`Namebook` the dispatch loop consults each tick.  Workers never
talk to each other — psi flows worker -> coordinator -> graph combine ->
worker, so membership changes (loss, elastic rejoin) are a single-writer
update here rather than a distributed agreement problem.

The namebook is also where the dedup ledger lives: ``record_reply``
accepts a ``(server, version)``-keyed contribution exactly once and
reports duplicates (re-delivered replies from retried dispatches) so the
caller folds each flush exactly once — the receiver half of the
at-least-once delivery contract (the reference's docs/fleet.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class WorkerEntry:
    """One worker's ledger row."""
    name: str
    server: int                       # its row p of the combination matrix
    alive: bool = False
    address: Optional[tuple] = None   # (host, port) in socket mode
    pid: Optional[int] = None         # OS pid (process realizations)
    last_heartbeat: float = 0.0       # monotonic receive time
    tick_done: int = -1               # last tick it acknowledged
    version: int = 0                  # its flush count (the dedup clock)
    restarts: int = 0
    retries: int = 0                  # send/collect retries spent on it

    def heartbeat_age(self, now: Optional[float] = None) -> float:
        if self.last_heartbeat <= 0.0:
            return float("inf")
        return max(0.0, (time.monotonic() if now is None else now)
                   - self.last_heartbeat)


class Namebook:
    """name -> :class:`WorkerEntry`, plus the ``(server, version)`` dedup
    set.  Single-writer: only the coordinator mutates it."""

    def __init__(self, num_servers: int):
        self.P = num_servers
        self.workers: Dict[str, WorkerEntry] = {
            worker_name(p): WorkerEntry(worker_name(p), p)
            for p in range(num_servers)
        }
        self._seen: set = set()       # (server, version) flushes folded

    def entry(self, name: str) -> WorkerEntry:
        return self.workers[name]

    def by_server(self, p: int) -> WorkerEntry:
        return self.workers[worker_name(p)]

    # ------------------------------------------------------------ membership

    def hello(self, name: str, *, address=None, pid=None,
              tick_done: int = -1, version: int = 0) -> WorkerEntry:
        """Register (or re-register after an elastic restart) a worker.

        A re-registration of a name that was already alive is counted as a
        restart too: it means the worker lost state and came back without
        the coordinator noticing the death first.
        """
        e = self.workers[name]
        if e.last_heartbeat > 0.0:       # not the first hello ever
            e.restarts += 1
        e.alive = True
        e.address = tuple(address) if address is not None else e.address
        e.pid = pid if pid is not None else e.pid
        e.last_heartbeat = time.monotonic()
        e.tick_done = tick_done
        e.version = version
        return e

    def mark_lost(self, name: str) -> None:
        self.workers[name].alive = False

    def heartbeat(self, name: str) -> None:
        e = self.workers.get(name)
        if e is not None:
            e.last_heartbeat = time.monotonic()

    # ------------------------------------------------------------ liveness

    def live_servers(self) -> list:
        return sorted(e.server for e in self.workers.values() if e.alive)

    def down_servers(self) -> list:
        return sorted(e.server for e in self.workers.values() if not e.alive)

    def heartbeat_ages(self) -> list:
        """[P] heartbeat age per server row (inf before first contact)."""
        now = time.monotonic()
        out = [0.0] * self.P
        for e in self.workers.values():
            out[e.server] = e.heartbeat_age(now)
        return out

    # ------------------------------------------------------------ dedup

    def record_reply(self, server: int, version: int) -> bool:
        """True the FIRST time this ``(server, version)`` flush is seen;
        False for re-deliveries (the caller must not fold them again)."""
        key = (int(server), int(version))
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    # ------------------------------------------------------------ telemetry

    def totals(self) -> Tuple[int, int]:
        """(total retries, total restarts) across the fleet."""
        return (sum(e.retries for e in self.workers.values()),
                sum(e.restarts for e in self.workers.values()))


def worker_name(p: int) -> str:
    return f"worker{p}"


COORDINATOR = "coordinator"
