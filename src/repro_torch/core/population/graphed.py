"""The round graph: the port's compiled executor, the counterpart of the
reference's jitted step and of ``_run_pure_scan``.

The reference never runs a round eagerly: ``make_gfl_step`` is
``jax.jit``-ed, and ``run_gfl_population(scan=True)`` compiles the whole
run as one ``lax.scan`` whose body regenerates the cohort, so peak memory
stays at one cohort.  Here one round is captured as a
:class:`torch.cuda.CUDAGraph` and replayed once a round.  The graph holds
one round, not the run: capturing costs about as much host time as one
eager pass over the same ops, so a graph replayed once saves nothing, and
a graph of the run would hold T rounds of nodes.  A round's graph pays its
capture once for T - 1 replays, and, like the scan body, holds one cohort.

Per round the host stage (:meth:`~repro_torch.core.gfl.StagedStep.stage`)
reseeds the three generators of the run's draws, which are registered
with the graph (a replay reads their seeds and offsets as they stand),
copies a fault process's A_i and masks into the step's buffers, and picks
the graph: with ``combine_every > 1`` there are two, one that combines and
one that does not (the reference's ``lax.cond``).  The population
engine's weighted round (``engine.StagedWeightedStep``) stages its
availability [P, K] and dropout masks too, through pinned slots
(:class:`PinnedCopies`), and its body draws its own cohort from the
probabilities it computes, records the round's q, and updates the
sampler's state in place.  The body reads only
buffers made once a run (params, the round counter, the sigma table, A,
the straggler cache and ages), writes the new params, records the MSD and
the straggler ages at the counter into [T] and [T, P] buffers, and
advances the counter.  Nothing is copied to the host until the run ends.

Each graph is captured the first time its round comes after one eager run
of the same body on the capture stream: that warm-up is a real round, and
it builds the kernels, initializes cuBLAS and fills the allocator.  The
graphs are freed when the run ends, and their private memory pool with
them: every run captures its own.  Warm-ups and captures are timed on
the host for the phase profiler (:mod:`repro_torch.telemetry.profile`:
``compile_s``; a capture of a :func:`graph_key` new to the process is a
``retraces``).  :data:`repro_torch.kernels.LAUNCHES` counts what a replay launches:
a capture's counts are taken back, and added again at every replay
(:data:`repro_torch.kernels.REPLAYED` keeps that share apart).  A capture
or replay that fails raises: nothing here runs the eager executor instead.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core import gfl
from repro_torch.telemetry.profile import note_capture, note_warmup

EXECUTORS = ("graph", "eager")


def resolve_executor(executor, device: torch.device) -> str:
    """``executor`` checked against the device: None is the round graph on
    a card and eager on the CPU, which has no graphs."""
    if executor is None:
        return "graph" if device.type == "cuda" else "eager"
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; expected one of "
                         f"{EXECUTORS}")
    if executor == "graph" and device.type != "cuda":
        raise ValueError(f"the round graph needs a CUDA device, not {device}; "
                         "run executor='eager'")
    return executor


def run_rounds(step: gfl.StagedStep, draw_batch: Optional[Callable], draws,
               iters: int, w_ref: torch.Tensor, *, capture: bool = True):
    """Run ``iters`` rounds of ``step``; ``draw_batch(i)`` draws round i's
    cohort batch from ``draws`` (None: the body draws its own, as the
    weighted round does from its probabilities).  With ``capture`` the
    body is replayed from CUDA graphs, else it runs eagerly (stage, then
    body: what the graph holds, runnable on the CPU).  Returns (MSD [iters], params
    [P, D], straggler ages [iters, P] or None), on the device."""
    dev = step.params.device
    msd = torch.zeros(iters, dtype=torch.float32, device=dev)
    ages = (None if step.psi_age is None else
            torch.zeros((iters,) + tuple(step.psi_age.shape),
                        dtype=step.psi_age.dtype, device=dev))

    def body(i: int, combine: bool) -> None:
        step.body(None if draw_batch is None else draw_batch(i), draws, i,
                  combine)
        dev_msd = ((gfl.centroid(step.params) - w_ref) ** 2).sum()
        msd.index_copy_(0, step.counter, dev_msd.reshape(1))
        if ages is not None:
            ages.index_copy_(0, step.counter, step.psi_age[None])
        step.counter.add_(1)

    if capture:
        _replay_rounds(body, step, draws, iters)
    else:
        for i in range(iters):
            body(i, step.stage(i, draws))
    return msd, step.params, ages


def graph_key(step: gfl.StagedStep, iters: int, combine: bool) -> tuple:
    """What a round graph's ops depend on: the step's kind, its config
    (telemetry and sanitize aside: they add no op but the taps), the
    shapes and types of the buffers it holds, the taps it writes, the
    run's length and the combine variant.  The phase profiler counts a
    capture of a key the process has not captured before as a retrace."""
    held = vars(step)
    cfg = replace(step.cfg, telemetry="off", sanitize=False)
    return (type(step).__qualname__, str(step.params.device), repr(cfg),
            tuple((name, tuple(v.shape), v.dtype)
                  for name, v in sorted(held.items())
                  if isinstance(v, torch.Tensor)),
            tuple(sorted(name for name, v in held.items()
                         if name.endswith("_tap") and v is not None)),
            iters, combine)


def _replay_rounds(body: Callable, step: gfl.StagedStep, draws,
                   iters: int) -> None:
    gens = draws.generators()        # ReplayDraws raises: eager only
    dev = step.params.device
    side = _capture_stream(dev)
    main = torch.cuda.current_stream(dev)
    graphs: dict = {}
    try:
        for i in range(iters):
            combine = step.stage(i, draws)
            graph = graphs.get(combine)
            if graph is None:
                side.wait_stream(main)
                t0 = time.perf_counter()
                with torch.cuda.stream(side):
                    if combine not in graphs:       # the warm-up round
                        body(i, combine)
                        graphs[combine] = None
                    else:
                        graph = graphs[combine] = _capture(
                            lambda: body(i, combine), gens, side)
                main.wait_stream(side)
                seconds = time.perf_counter() - t0
                if graph is None:
                    note_warmup(seconds)
                    continue
                note_capture(seconds, graph_key(step, iters, combine))
            graph[0].replay()
            K.count_replay(graph[1])
    finally:
        graphs.clear()                # the graphs and their pools go


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's one stream for warm-up rounds and captures, made once
    a process.  cuBLAS keeps a workspace for every stream that runs a
    matmul (32 MiB a stream on Hopper) for the life of the process; a new
    stream a run would add one each run with the kernels off."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _capture(fn: Callable, gens, stream) -> tuple:
    """(graph, kernel launches it holds) of ``fn`` captured on ``stream``,
    with the draws' generators registered."""
    graph = torch.cuda.CUDAGraph()
    for gen in gens:
        graph.register_generator_state(gen)
    before = dict(K.LAUNCHES)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    held = {k: n - before[k] for k, n in K.LAUNCHES.items() if n != before[k]}
    for k, n in held.items():          # a capture launches nothing
        K.LAUNCHES[k] -= n
    return graph, held


class PinnedCopies:
    """Host arrays into a step's device buffers before a replay, through
    pinned slots.  A copy from pageable memory is synchronous: it waits
    for the replay before it and holds the host.  From a pinned slot it is
    queued behind that replay and the host goes on to stage the next
    round.  The weighted round stages its [P, K] availability so; the
    faulted pure round's few hundred bytes (``runtime.stage_round``) are
    copied from pageable memory, which measured faster for them.  Each buffer has two slots, used in turn;
    a slot is written again only once the copy out of it has run (its
    event).  On the CPU the copy is a plain ``copy_``."""

    SLOTS = 2

    def __init__(self):
        self._rings: dict = {}

    def copy(self, dst: torch.Tensor, array: np.ndarray) -> None:
        src = torch.from_numpy(np.ascontiguousarray(array))
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        ring = self._rings.get(dst.data_ptr())
        if ring is None:
            ring = self._rings[dst.data_ptr()] = [0, [
                (torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True),
                 torch.cuda.Event()) for _ in range(self.SLOTS)]]
        turn, slots = ring
        slot, done = slots[turn % self.SLOTS]
        ring[0] = turn + 1
        done.synchronize()          # the copy out of this slot has run
        slot.copy_(src)
        dst.copy_(slot, non_blocking=True)
        done.record()
