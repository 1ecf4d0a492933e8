"""Pluggable fleet transports: the one seam every byte crosses (a copy of
the reference's ``core/fleet/transport.py``: the same wire form, so a
:class:`Message` encodes to the reference's bytes; nothing here touches
torch, and a device vector is read to the host before
:func:`pack_array` sees it — float32 values travel exactly, as float32
is a subset of float64).

Psi exchanges, cohort dispatches, heartbeats and restart hellos all
travel as :class:`Message` envelopes over a :class:`Transport` — the
fleet's coordinator and workers never touch a queue, file or socket
directly (gflint GFL008 enforces that raw ``socket``/``subprocess`` use
stays inside ``core/fleet/``).  Three realizations, selected by the
``fleet`` spec grammar (:mod:`repro_torch.core.fleet.spec`):

``inproc``
    per-endpoint ``queue.Queue`` behind a shared :class:`InprocHub` —
    workers run as threads in one process.  The tier-1-safe realization:
    chaos tests "kill" a worker by halting its thread and restart it
    from its checkpoint, no subprocesses involved.

``filelog``
    one append-only JSONL log per endpoint under a shared directory;
    ``send`` appends one line to the destination's log (O_APPEND
    single-write, so concurrent senders interleave whole records),
    ``recv`` tails the endpoint's own log from a cursor.  A restarted
    endpoint re-reads its log from offset 0 — delivery is *replay*, and
    the receiver-side idempotent dedup (tick / ``(server, version)``
    keys) turns at-least-once replay into exactly-once effect.  The
    cursor distance to the end of the log is the ``replay_lag``
    telemetry.

``socket``
    length-prefixed JSON over TCP: each endpoint owns a listening socket
    (an acceptor thread drains connections into a local queue) and
    ``send`` opens a short-lived connection to the destination address
    from the namebook.  Connection failures surface as
    :class:`TransportError` for the retry/backoff layer.

Delivery contract shared by all three: **at-least-once, sender-retried,
receiver-deduped**.  :func:`send_with_retry` implements the bounded
retry + exponential backoff send path; receivers must tolerate
duplicates (the protocol keys — dispatch tick, psi ``(server,
version)`` — make every handler idempotent).
"""
from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time
from abc import ABC, abstractmethod
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.core.fleet.spec import FleetSpec


class TransportError(RuntimeError):
    """A send/recv attempt failed (the retry layer's signal)."""


class Message(NamedTuple):
    """One fleet protocol envelope.

    ``kind``     hello | cohort | psi | heartbeat | stop | bye
    ``sender``   endpoint name ("coordinator", "worker3")
    ``version``  sender's protocol clock: the dispatch tick for cohort
                 messages, the flush count for psi messages
    ``payload``  JSON-serializable dict; arrays travel as nested lists
    """
    kind: str
    sender: str
    version: int
    payload: dict

    def encode(self) -> bytes:
        return json.dumps({"kind": self.kind, "sender": self.sender,
                           "version": self.version,
                           "payload": self.payload}).encode("utf-8")

    @classmethod
    def decode(cls, blob: bytes) -> "Message":
        doc = json.loads(blob.decode("utf-8"))
        return cls(doc["kind"], doc["sender"], int(doc["version"]),
                   doc.get("payload", {}))


def pack_array(a) -> list:
    """Arrays -> nested lists (the JSON wire form)."""
    return np.asarray(a, np.float64).tolist()


def unpack_array(v) -> np.ndarray:
    return np.asarray(v, np.float64)


class Transport(ABC):
    """One endpoint's view of the message substrate."""

    name: str = "?"        # this endpoint's name
    kind: str = "?"        # inproc | filelog | socket

    @abstractmethod
    def send(self, dest: str, msg: Message) -> None:
        """Deliver ``msg`` to ``dest``'s inbox (raises TransportError)."""

    @abstractmethod
    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Next inbound message, or None after ``timeout`` seconds."""

    def stats(self) -> dict:
        """Transport health counters (``replay_lag`` = records queued or
        logged but not yet consumed by this endpoint)."""
        return {"replay_lag": 0}

    def close(self) -> None:
        pass


def send_with_retry(transport: Transport, dest: str, msg: Message,
                    spec: FleetSpec,
                    on_retry: Optional[Callable[[int], None]] = None
                    ) -> bool:
    """Bounded-retry + backoff send (the fleet's only send path).

    Attempts ``1 + spec.retry`` sends, sleeping ``spec.backoff_delay(a)``
    between attempts; ``on_retry(attempt)`` lets the caller count retries
    into telemetry.  Returns True on success, False when the budget is
    exhausted — the caller decides whether that means a lost worker.
    Duplicated deliveries from earlier half-failed attempts are the
    receiver's (idempotent) problem, by design.
    """
    for attempt in range(1 + spec.retry):
        try:
            transport.send(dest, msg)
            return True
        except TransportError:
            if attempt >= spec.retry:
                return False
            if on_retry is not None:
                on_retry(attempt)
            time.sleep(min(spec.backoff_delay(attempt), 2.0))
    return False


# ---------------------------------------------------------------------------
# inproc: shared-hub queues (threads in one process; tier-1-safe)
# ---------------------------------------------------------------------------


class InprocHub:
    """Shared endpoint registry for one in-process fleet: name -> queue."""

    def __init__(self):
        self._queues: Dict[str, queue.Queue] = {}
        self._lock = threading.Lock()

    def register(self, name: str) -> "InprocTransport":
        with self._lock:
            # a restarted endpoint re-registers: it gets a FRESH queue, so
            # messages addressed to its dead incarnation are dropped (the
            # coordinator re-dispatches — at-least-once end to end)
            self._queues[name] = queue.Queue()
        return InprocTransport(self, name)

    def queue_for(self, name: str) -> queue.Queue:
        with self._lock:
            q = self._queues.get(name)
        if q is None:
            raise TransportError(f"inproc endpoint {name!r} not registered")
        return q


class InprocTransport(Transport):
    kind = "inproc"

    def __init__(self, hub: InprocHub, name: str):
        self.hub = hub
        self.name = name

    def send(self, dest: str, msg: Message) -> None:
        self.hub.queue_for(dest).put(msg.encode())

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            blob = self.hub.queue_for(self.name).get(timeout=timeout)
        except queue.Empty:
            return None
        return Message.decode(blob)

    def stats(self) -> dict:
        try:
            return {"replay_lag": self.hub.queue_for(self.name).qsize()}
        except TransportError:
            return {"replay_lag": 0}


# ---------------------------------------------------------------------------
# filelog: per-endpoint append-only replay logs
# ---------------------------------------------------------------------------


class FileLogTransport(Transport):
    """Append-only JSONL per endpoint under ``root``; recv tails own log.

    The log IS the delivery history: a restarted endpoint replays it from
    offset 0, and receiver-side dedup makes the replay idempotent.  A
    send is one ``write()`` of one newline-terminated record on an
    O_APPEND descriptor, so concurrent senders never tear each other's
    lines.
    """
    kind = "filelog"

    def __init__(self, root: str, name: str, *, poll: float = 0.02,
                 replay: bool = True):
        self.root = root
        self.name = name
        self.poll = poll
        os.makedirs(root, exist_ok=True)
        self._path = self._log_path(name)
        # touch own log so lag/replay reads never race creation
        with open(self._path, "a", encoding="utf-8"):
            pass
        self._fh = open(self._path, "r", encoding="utf-8")
        if not replay:
            self._fh.seek(0, os.SEEK_END)

    def _log_path(self, endpoint: str) -> str:
        return os.path.join(self.root, f"{endpoint}.log")

    def send(self, dest: str, msg: Message) -> None:
        line = msg.encode() + b"\n"
        try:
            fd = os.open(self._log_path(dest),
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
        except OSError as e:
            raise TransportError(f"filelog append to {dest!r} failed: {e}")

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            line = self._fh.readline()
            if line:
                line = line.strip()
                if not line:
                    continue
                try:
                    return Message.decode(line.encode("utf-8"))
                except (json.JSONDecodeError, KeyError):
                    continue   # torn tail line: wait for the full record
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.poll)

    def stats(self) -> dict:
        try:
            behind = os.path.getsize(self._path) - self._fh.tell()
        except OSError:
            behind = 0
        # records, not bytes: count unconsumed newline-terminated lines
        lag = 0
        if behind > 0:
            with open(self._path, "rb") as fh:
                fh.seek(self._fh.tell())
                lag = fh.read().count(b"\n")
        return {"replay_lag": lag}

    def close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# socket: length-prefixed JSON over TCP
# ---------------------------------------------------------------------------


_LEN = struct.Struct(">I")


class SocketTransport(Transport):
    """TCP endpoint: own listener + short-lived connections per send.

    The acceptor thread drains inbound connections into a local queue so
    ``recv`` has queue semantics like the other transports.  Destination
    addresses come from the ``addresses`` map (the namebook's transport
    view) which the coordinator keeps current as workers register and
    restart.
    """
    kind = "socket"

    def __init__(self, name: str, addresses: Dict[str, tuple], *,
                 host: str = "127.0.0.1", port: int = 0):
        self.name = name
        self.addresses = addresses     # name -> (host, port), shared/mutated
        self._inbox: queue.Queue = queue.Queue()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.address = self._srv.getsockname()
        addresses[name] = tuple(self.address)
        self._closing = threading.Event()
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True,
                                          name=f"fleet-accept-{name}")
        self._acceptor.start()

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._closing.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                with conn:
                    conn.settimeout(5.0)
                    header = _recv_exact(conn, _LEN.size)
                    if header is None:
                        continue
                    (n,) = _LEN.unpack(header)
                    blob = _recv_exact(conn, n)
                    if blob is not None:
                        self._inbox.put(blob)
            except OSError:
                continue

    def send(self, dest: str, msg: Message) -> None:
        addr = self.addresses.get(dest)
        if addr is None:
            raise TransportError(f"no address registered for {dest!r}")
        blob = msg.encode()
        try:
            with socket.create_connection(tuple(addr), timeout=2.0) as conn:
                conn.sendall(_LEN.pack(len(blob)) + blob)
        except OSError as e:
            raise TransportError(f"socket send to {dest!r}{addr} "
                                 f"failed: {e}")

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            blob = self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None
        return Message.decode(blob)

    def stats(self) -> dict:
        return {"replay_lag": self._inbox.qsize()}

    def close(self) -> None:
        self._closing.set()
        try:
            self._srv.close()
        except OSError:
            pass


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def make_transport(spec: FleetSpec, name: str, *, hub=None, root=None,
                   addresses=None, replay: bool = True) -> Transport:
    """Build this endpoint's transport for the spec'd substrate.

    ``hub`` (inproc), ``root`` (filelog) and ``addresses`` (socket) are
    the substrate-shared rendezvous objects — the coordinator creates
    them and hands the relevant one to each worker.
    """
    if spec.transport == "inproc":
        if hub is None:
            raise ValueError("inproc transport needs the shared hub")
        return hub.register(name)
    if spec.transport == "filelog":
        if root is None:
            raise ValueError("filelog transport needs a log directory")
        return FileLogTransport(root, name, replay=replay)
    if addresses is None:
        raise ValueError("socket transport needs the shared address map")
    return SocketTransport(name, addresses)
