"""Phase-level profiler: capture/build vs execute vs drain attribution (port
of ``repro.telemetry.profile``).

:func:`profile_phase` wraps a phase (the names ``trace_span`` uses — with
``session(profile=True)`` or ``REPRO_TELEMETRY_PROFILE=1`` every
``trace_span`` becomes a ``profile_phase``) and emits one ``profile``
stream record attributing the phase's wall clock:

``compile_s``    seconds inside the phase spent in the round graph's
                 warm-up rounds and CUDA-graph captures
                 (:mod:`repro_torch.core.population.graphed`) and in
                 ``nvcc`` builds (:mod:`repro_torch.kernels._build`);
``retraces``     captures of a round graph whose key (``graphed.
                 graph_key``: the step's kind, config and buffer shapes,
                 the run's length, the combine variant) the process has
                 not captured before: the counterpart of the reference's
                 jit cache misses.  Every run captures its graphs anew
                 (they are freed with the run), and those seconds are in
                 ``compile_s``; a second run of the same shape reads 0
                 retraces, so a retrace there means the key changed: the
                 port's *silent recompile*;
``compiles``     ``nvcc`` builds inside the phase (0 once the kernels
                 are built);
``callback_s``   host seconds draining and ingesting telemetry records
                 (``TelemetrySession.callback_seconds``) — the cost of
                 observation itself;
``execute_s``    the remainder (device execute + host driver).

On a card the phase's edges wait for the device (``torch.cuda.
synchronize``), so ``wall_s`` holds the work the phase queued; nothing
is timed inside a round.  ``peak_bytes`` is ``torch.cuda.
max_memory_allocated`` after the phase, absent on the CPU.

With no active telemetry session everything here is a no-op.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

# process-lifetime accumulators; phases snapshot + diff them
_COUNTERS = {"compile_s": 0.0, "retraces": 0, "compiles": 0}
_CAPTURED: set = set()      # the graph keys captured in this process


def note_capture(seconds: float, key) -> None:
    """One round-graph capture of ``key`` took ``seconds``; a key not
    captured before is a retrace."""
    _COUNTERS["compile_s"] += float(seconds)
    if key not in _CAPTURED:
        _CAPTURED.add(key)
        _COUNTERS["retraces"] += 1


def note_warmup(seconds: float) -> None:
    """A warm-up round before a capture took ``seconds``."""
    _COUNTERS["compile_s"] += float(seconds)


def note_build(seconds: float, sources: int) -> None:
    """``sources`` nvcc builds, run together, took ``seconds``."""
    _COUNTERS["compile_s"] += float(seconds)
    _COUNTERS["compiles"] += int(sources)


def compile_counters() -> Dict[str, float]:
    """A snapshot of the process-lifetime capture/build accumulators."""
    return dict(_COUNTERS)


def _sync() -> None:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_peak_bytes() -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of the current card (None
    without one)."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.max_memory_allocated())


@contextmanager
def profile_phase(name: str, **args):
    """Wrap one host-side phase: span-trace it AND emit a ``profile``
    stream record attributing its wall time.  No-op without a session."""
    from repro_torch.telemetry.stream import current_session, emit
    sess = current_session()
    if sess is None:
        yield
        return
    _sync()
    before = compile_counters()
    cb_before = sess.callback_seconds
    t0 = time.perf_counter()
    span = (sess.tracer.span(name, **args) if sess.tracer is not None
            else nullcontext())
    try:
        with span:
            yield
            _sync()
    finally:
        wall = time.perf_counter() - t0
        after = compile_counters()
        compile_s = after["compile_s"] - before["compile_s"]
        callback_s = sess.callback_seconds - cb_before
        rec = {
            "seq": sess.next_seq(), "phase": name,
            "wall_s": wall, "compile_s": compile_s,
            "execute_s": max(0.0, wall - compile_s - callback_s),
            "callback_s": callback_s,
            "retraces": int(after["retraces"] - before["retraces"]),
            "compiles": int(after["compiles"] - before["compiles"]),
        }
        peak = device_peak_bytes()
        if peak is not None:
            rec["peak_bytes"] = float(peak)
        emit("profile", rec)
