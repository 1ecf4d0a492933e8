"""Fleet worker: one server's slice of the event engine, crash-consistent
(port of ``repro.core.fleet.worker``).

A worker owns row ``p`` of the protocol: it folds its dispatched cohort's
client updates into a buffer, flushes (announces a protected psi and
charges its privacy ledger) when the buffer fills, and replies to the
coordinator.  Everything it computes is a pure function of ``(seeds,
server, tick)`` — client shards, cohort updates and the flush noise are
all derived from counter-based generators — which is what makes crash
recovery *exact*: a restarted worker that replays a tick recomputes
bit-identical results.

What differs from the reference is where the fold runs.  The worker's
model, buffer sum and cached psi are [dim] float32 tensors on its device,
beside its K clients' shards stacked once as H [K, n, dim] and gamma [K, n]
(pure in ``(data_seed, p, k)``, so a restarted worker rebuilds them).  A
tick forms the cohort's [E, dim] logistic gradients in plain torch and
folds them with :func:`repro_torch.kernels.ops.round_fold` at P = 1, L = E:
K1 ``fold_norms`` + K2 ``fold_apply`` on a card, their plain versions on
the CPU — the cohort mean of ``w - mu clip_B(grad)``.  The gradient is
written without matmuls (no cuBLAS, whose results may differ across
streams), and K1 and K2 use no float atomics, so a replayed tick is
bitwise the first one on a card too.  The counters (``buf_wsum``,
``buf_n``, ``version``, ``tick_done``, the q ledger) stay host values, so
the flush decision never reads the device.  The flush noise stays
numpy's ``default_rng`` on the reference's stream tags, bit for bit, and
is copied to the device.

Crash consistency is write-ahead checkpointing through
:mod:`repro_torch.checkpoint.io` (crash-atomic ``os.replace`` publish):
every ``ckpt_every`` ticks the worker persists ``(params, buffer state,
version, tick_done, accountant q-ledger, last reply)`` BEFORE sending its
reply — the reference's twelve keys, so either package restores the
other's worker.  Combined with the dedup keys this yields exactly-once
folding across kills:

* killed before the checkpoint — the coordinator never saw the reply; the
  re-dispatched tick is recomputed deterministically, same fold;
* killed between checkpoint and send — the restored worker sees the
  re-dispatched tick is ``<= tick_done`` and resends the CHECKPOINTED
  reply without re-folding (idempotent replay);
* duplicate delivery (a retried dispatch whose original did arrive) hits
  the same ``tick <= tick_done`` guard.

A worker on a card runs every op on a CUDA stream of its own (the current
stream is per thread, and the kernels' workspaces are cached per stream),
so the in-process realization's worker threads share the card.
:func:`worker_process_main` is the entry of spawned worker processes
(filelog / socket): it takes the device as a string, and on a card loads
the already-built kernels before its hello — a worker that cannot reach
its device or load a kernel dies before it says hello, and the
coordinator's hello deadline reports it.
"""
from __future__ import annotations

import json
import os
import threading
from contextlib import nullcontext
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.fleet.namebook import COORDINATOR, worker_name
from repro_torch.core.fleet.spec import FleetSpec, parse_fleet_spec
from repro_torch.core.fleet.transport import (Message, Transport,
                                              make_transport, pack_array,
                                              send_with_retry, unpack_array)
from repro_torch.kernels import ops

_SHARD_TAG = 0xDA7A     # client data stream
_NOISE_TAG = 0x4015E    # flush (release) noise stream

#: the kernels a worker's tick launches (K1 + K2), loaded before its hello
WORKER_KERNELS = ("fold_norms", "fold_apply")
#: checkpoint keys that live on the worker's device
DEVICE_KEYS = ("params", "buf_sum", "psi_cache")


@dataclass(frozen=True)
class FleetProblem:
    """The fleet's shared protocol constants (picklable; rides the spawn
    args of every worker process).  Mirrors the Section V logistic setup
    at fleet scale: client ``(p, k)``'s shard is a pure function of
    ``(data_seed, p, k)``."""
    P: int = 4
    K: int = 20            # clients per server
    n: int = 20            # samples per client
    dim: int = 2
    rho: float = 0.01
    mu: float = 0.05
    grad_bound: float = 5.0
    buffer: int = 8        # arrivals per flush (AsyncSpec.buffer analogue)
    events: int = 4        # cohort size per dispatch tick
    sigma_g: float = 0.0   # flush Laplace noise std (0 = noiseless)
    data_seed: int = 0
    seed: int = 0          # protocol seed (noise stream)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetProblem":
        return cls(**d)


def client_shard(prob: FleetProblem, p: int, k: int):
    """(h [n, dim], gamma [n]) of client ``(p, k)`` — pure in
    ``(data_seed, p, k)`` (the population-engine sharding discipline)."""
    rng = np.random.default_rng((_SHARD_TAG, prob.data_seed, p, k))
    gamma = np.where(rng.random(prob.n) < 0.5, -1.0, 1.0)
    sigma_h = 0.5 + rng.random()            # heterogeneous client noise
    h = gamma[:, None] + rng.normal(0.0, sigma_h, (prob.n, prob.dim))
    return h, gamma


def logistic_grad(w: np.ndarray, h: np.ndarray, gamma: np.ndarray,
                  rho: float) -> np.ndarray:
    """grad of the rho-regularized mean logistic loss (numpy, float64; the
    reference solution's)."""
    margins = gamma * (h @ w)
    sig = 1.0 / (1.0 + np.exp(np.clip(margins, -50.0, 50.0)))
    return -(gamma * sig) @ h / len(gamma) + rho * w


def clip_to_bound(g: np.ndarray, bound: float) -> np.ndarray:
    if bound <= 0:
        return g
    nrm = float(np.linalg.norm(g))
    return g * min(1.0, bound / max(nrm, 1e-12))


def flush_noise(prob: FleetProblem, p: int, version: int) -> np.ndarray:
    """Release ``version``'s Laplace draw, ``Lap(0, sigma_g/sqrt 2)`` per
    coordinate (std sigma_g, the homomorphic-mechanism convention) — pure
    in ``(seed, p, version)`` so a replayed flush re-draws identically."""
    if prob.sigma_g <= 0:
        return np.zeros(prob.dim)
    rng = np.random.default_rng((_NOISE_TAG, prob.seed, p, version))
    return rng.laplace(0.0, prob.sigma_g / np.sqrt(2.0), prob.dim)


def client_shards(prob: FleetProblem, p: int, device) -> tuple:
    """Server ``p``'s K shards stacked on ``device``: (H [K, n, dim],
    gamma [K, n]) float32, from :func:`client_shard`."""
    hs, gs = zip(*(client_shard(prob, p, k) for k in range(prob.K)))
    return (torch.from_numpy(np.stack(hs).astype(np.float32)).to(device),
            torch.from_numpy(np.stack(gs).astype(np.float32)).to(device))


def cohort_grads(h: torch.Tensor, gamma: torch.Tensor, w: torch.Tensor,
                 rho: float) -> torch.Tensor:
    """[E, dim] logistic gradients of the cohort's shards h [E, n, dim],
    gamma [E, n] at w [dim] (:func:`logistic_grad` per client).  Products
    and sums only, no matmul: no cuBLAS on the worker's path."""
    margins = gamma * (h * w).sum(-1)
    sig = 1.0 / (1.0 + torch.exp(margins.clamp(-50.0, 50.0)))
    return -((gamma * sig)[..., None] * h).sum(1) / gamma.shape[-1] \
        + rho * w


def load_kernels(device: torch.device) -> None:
    """Load the worker's kernels on a card (built once by the fleet before
    it spawns workers); raises when one cannot be built or loaded."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        for name in WORKER_KERNELS:
            _build.function(name)


# ---------------------------------------------------------------------------
# checkpoint pytree (variable-shape q ledger => manifest-driven "like")
# ---------------------------------------------------------------------------


def load_worker_checkpoint(path: str, device=None) -> Optional[dict]:
    """Restore a worker state dict, or None when no checkpoint exists.

    The state carries a variable-length ``q_history`` ledger, so the
    ``like`` tree :func:`repro_torch.checkpoint.io.load_checkpoint`
    validates against is built from the manifest's own recorded
    shapes/dtypes.  With ``device`` the :data:`DEVICE_KEYS` are restored as
    float32 tensors there (a reference worker's float64 state is cast);
    without it every leaf stays a numpy array at its stored dtype."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        return None
    from repro_torch.checkpoint.io import load_checkpoint
    with open(manifest_path) as f:
        manifest = json.load(f)
    like = {}
    for k in manifest["keys"]:
        shape = manifest["shapes"][k]
        if device is not None and k in DEVICE_KEYS:
            like[k] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            like[k] = np.zeros(shape, np.dtype(manifest["dtypes"][k]))
    tree, _ = load_checkpoint(path, like)
    return tree


class FleetWorker:
    """The worker event loop (one per server row).

    Runs until a ``stop`` message (graceful: final checkpoint + ``bye``)
    or until ``kill_flag`` is set (the inproc chaos realization of
    SIGKILL: the loop aborts WITHOUT checkpointing, exactly like a killed
    process).  Process realizations are killed for real — see
    :mod:`repro_torch.core.fleet.coordinator`.
    """

    def __init__(self, p: int, prob: FleetProblem, spec: FleetSpec,
                 transport: Transport, ckpt_dir: str, *, device=None):
        self.p = p
        self.prob = prob
        self.spec = spec
        self.transport = transport
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.name = worker_name(p)
        self.kill_flag = threading.Event()
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

        with self.on_stream():
            self.H, self.gamma = client_shards(prob, p, self.device)
            restored = load_worker_checkpoint(ckpt_dir, self.device)
            zeros = torch.zeros(prob.dim, dtype=torch.float32,
                                device=self.device)
        if restored is not None:
            self.params = restored["params"]
            self.buf_sum = restored["buf_sum"]
            self.buf_wsum = float(restored["buf_wsum"])
            self.buf_n = int(restored["buf_n"])
            self.version = int(restored["version"])
            self.psi_cache = restored["psi_cache"]
            self.tick_done = int(restored["tick_done"])
            self.q_history = [float(v) for v in
                              np.atleast_1d(restored["q_history"])
                              [:self.version]]
            self.last_reply = {
                "tick": int(restored["last_tick"]),
                "psi": pack_array(restored["last_psi"]),
                "flushed": int(restored["last_flushed"]),
                "q": float(restored["last_q"]),
            }
        else:
            self.params = zeros
            self.buf_sum = zeros
            self.buf_wsum = 0.0
            self.buf_n = 0
            self.version = 0
            self.psi_cache = zeros
            self.tick_done = -1
            self.q_history: list = []
            self.last_reply: Optional[dict] = None

    def on_stream(self):
        """The worker's own CUDA stream as the current one (a no-op on the
        CPU)."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    # ------------------------------------------------------------ protocol

    def compute_tick(self, tick: int, w: np.ndarray, cohort: list) -> dict:
        """Fold the dispatched cohort, maybe flush; returns the reply
        payload.  Deterministic in ``(prob, tick, w, cohort)``."""
        prob, dev = self.prob, self.device
        self.params = torch.from_numpy(
            np.asarray(w, np.float32)).to(dev)
        n = len(cohort)
        if n:
            idx = torch.tensor([int(k) for k in cohort], device=dev)
            grads = cohort_grads(self.H[idx], self.gamma[idx], self.params,
                                 prob.rho)
            # K1 + K2 at P = 1, L = n: the mean of w - mu clip_B(grad_k)
            mean, _ = ops.round_fold(self.params[None], grads[None],
                                     mu=prob.mu, bound=prob.grad_bound)
            # age-0 fold: every staleness weight is 1, mass == count
            self.buf_sum = self.buf_sum + n * mean[0]
            self.buf_wsum += float(n)
            self.buf_n += n
        flushed = self.buf_n >= prob.buffer
        if flushed:
            psi = self.buf_sum / max(self.buf_wsum, 1e-12)
            self.version += 1
            noise = flush_noise(prob, self.p, self.version)
            psi = psi + torch.from_numpy(noise.astype(np.float32)).to(dev)
            q = min(1.0, self.buf_n / prob.K)
            self.q_history.append(q)
            self.buf_sum = torch.zeros_like(self.buf_sum)
            self.buf_wsum = 0.0
            self.buf_n = 0
            self.psi_cache = psi
        else:
            psi = self.psi_cache
            q = 0.0
        self.tick_done = tick
        return {"tick": tick, "psi": pack_array(psi.cpu().numpy()),
                "flushed": int(flushed), "q": q}

    def checkpoint(self) -> None:
        """Write-ahead checkpoint (crash-atomic via checkpoint/io.py); the
        device leaves are copied to the host, which waits for the worker's
        stream."""
        from repro_torch.checkpoint.io import save_checkpoint
        last = self.last_reply or {"tick": -1,
                                   "psi": pack_array(
                                       self.psi_cache.cpu().numpy()),
                                   "flushed": 0, "q": 0.0}
        save_checkpoint(self.ckpt_dir, {
            "params": self.params,
            "buf_sum": self.buf_sum,
            "buf_wsum": np.float64(self.buf_wsum),
            "buf_n": np.int64(self.buf_n),
            "version": np.int64(self.version),
            "psi_cache": self.psi_cache,
            "tick_done": np.int64(self.tick_done),
            "q_history": np.asarray(self.q_history, np.float64),
            "last_tick": np.int64(last["tick"]),
            "last_psi": unpack_array(last["psi"]),
            "last_flushed": np.int64(last["flushed"]),
            "last_q": np.float64(last["q"]),
        }, step=self.tick_done)

    def _reply(self, payload: dict) -> None:
        send_with_retry(self.transport, COORDINATOR,
                        Message("psi", self.name, self.version, payload),
                        self.spec)

    # ------------------------------------------------------------ main loop

    def run(self) -> None:
        with self.on_stream():
            self._run()

    def _run(self) -> None:
        hello = Message("hello", self.name, self.version, {
            "tick_done": self.tick_done, "pid": os.getpid(),
            "address": list(getattr(self.transport, "address", ()) or []),
        })
        send_with_retry(self.transport, COORDINATOR, hello, self.spec)
        stop_beats = threading.Event()
        beats = threading.Thread(target=self._heartbeat_loop,
                                 args=(stop_beats,), daemon=True,
                                 name=f"fleet-beats-{self.name}")
        beats.start()
        try:
            while not self.kill_flag.is_set():
                msg = self.transport.recv(timeout=min(self.spec.heartbeat,
                                                      0.1))
                if msg is None:
                    continue
                if msg.kind == "stop":
                    self.checkpoint()
                    send_with_retry(
                        self.transport, COORDINATOR,
                        Message("bye", self.name, self.version,
                                {"q_history": list(self.q_history)}),
                        self.spec)
                    return
                if msg.kind != "cohort":
                    continue
                tick = int(msg.payload["tick"])
                if tick <= self.tick_done:
                    # duplicate / replayed dispatch: resend the stored
                    # reply, fold NOTHING (exactly-once effect)
                    if self.last_reply is not None \
                            and self.last_reply["tick"] == tick:
                        self._reply(self.last_reply)
                    continue
                payload = self.compute_tick(
                    tick, unpack_array(msg.payload["w"]),
                    msg.payload["cohort"])
                self.last_reply = payload
                if tick % self.spec.ckpt_every == 0:
                    self.checkpoint()     # WRITE-AHEAD: persist, THEN reply
                if self.kill_flag.is_set():
                    return                # killed between checkpoint & send
                self._reply(payload)
        finally:
            stop_beats.set()
            # no thread outlives the loop: a daemon thread still running
            # while a spawned worker's interpreter finalizes has aborted
            # the child (SIGABRT) under torch
            beats.join()
            self.transport.close()

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.spec.heartbeat):
            if self.kill_flag.is_set():
                return
            try:
                self.transport.send(
                    COORDINATOR,
                    Message("heartbeat", self.name, self.version,
                            {"tick_done": self.tick_done}))
            except Exception:
                pass                      # missed beats ARE the signal


def worker_process_main(p: int, prob_dict: dict, spec_str: str,
                        ckpt_dir: str, transport_kind: str,
                        root: Optional[str],
                        coordinator_addr: Optional[tuple],
                        device: str) -> None:
    """Spawned-process entry point (filelog / socket transports).

    Arguments are plain picklable values, the device a string
    (``"cuda:0"``, ``"cpu"``); the transport is rebuilt inside the child.
    On a card the child loads its kernels before anything else, so a child
    that cannot reach the card or load a kernel raises before its hello.
    In socket mode the worker binds an ephemeral port and reports its
    address in the hello — the coordinator's namebook is the only place
    addresses accumulate.
    """
    dev = resolve_device(device)
    load_kernels(dev)
    prob = FleetProblem.from_dict(prob_dict)
    spec = parse_fleet_spec(spec_str)
    name = worker_name(p)
    if transport_kind == "filelog":
        transport = make_transport(spec, name, root=root)
    else:
        addresses = {} if coordinator_addr is None else \
            {COORDINATOR: tuple(coordinator_addr)}
        transport = make_transport(spec, name, addresses=addresses)
    FleetWorker(p, prob, spec, transport, ckpt_dir, device=dev).run()
