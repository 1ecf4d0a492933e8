"""Span tracer: Chrome/Perfetto trace-event JSON for engine phases (port of
``repro.telemetry.trace``).

``trace_span("population_run")`` wraps any host-side phase — engine setup,
the run, its accounting — and records a complete ("ph": "X") trace event
with microsecond timestamps.  The resulting file loads directly in
``chrome://tracing`` / Perfetto (``{"traceEvents": [...]}`` format).

Spans measure host wall time: a span around a run that replays a CUDA
graph ends when the host has queued the last replay, unless the phase
itself waits for the device (the engines copy their traces to the host at
the end of a run, which does).  For device-side profiling every span can
also pass through to ``torch.profiler.record_function`` (``annotate=True``
on the tracer, or ``REPRO_TELEMETRY_JAXPROF=1``, the reference's variable,
so one shell drives both packages), so spans show up in a torch.profiler
trace under the same names.

With no active telemetry session ``trace_span`` is a reusable no-op
context manager — zero allocation on the off path.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import List, Optional

ENV_ANNOTATE = "REPRO_TELEMETRY_JAXPROF"


class SpanTracer:
    """Collects trace events; ``save`` writes Chrome trace JSON."""

    def __init__(self, path=None, *, annotate: Optional[bool] = None):
        self.path = Path(path) if path else None
        self.events: List[dict] = []
        if annotate is None:
            annotate = os.environ.get(
                ENV_ANNOTATE, "0") not in ("", "0", "false")
        self.annotate = annotate
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args):
        ann = None
        if self.annotate:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        ts = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - ts
            self.events.append({
                "name": name, "ph": "X", "ts": ts, "dur": dur,
                "pid": self._pid, "tid": threading.get_ident() & 0xFFFF,
                "args": {k: _arg(v) for k, v in args.items()},
            })
            if ann is not None:
                ann.__exit__(None, None, None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        self.events.append({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "p",
            "pid": self._pid, "tid": threading.get_ident() & 0xFFFF,
            "args": {k: _arg(v) for k, v in args.items()},
        })

    def save(self, path=None) -> Optional[Path]:
        """Write ``{"traceEvents": [...]}``; returns the path (None when
        the tracer has nowhere to write)."""
        out = Path(path) if path else self.path
        if out is None:
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"traceEvents": self.events,
             "displayTimeUnit": "ms"}) + "\n", encoding="utf-8")
        return out


def _arg(value):
    if hasattr(value, "item"):
        return value.item()
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    return str(value)


@contextmanager
def _null_span():
    yield


def trace_span(name: str, **args):
    """Span against the active session's tracer (no-op when telemetry is
    off).  Usage: ``with trace_span("population_run", iters=T): ...``

    Profiling sessions (``session(profile=True)`` /
    ``REPRO_TELEMETRY_PROFILE=1``) additionally attribute every span's
    wall time to capture/build, execute and drain via the ``profile``
    stream (:mod:`repro_torch.telemetry.profile`)."""
    from repro_torch.telemetry.stream import current_session
    sess = current_session()
    if sess is None:
        return _null_span()
    if sess.profile:
        from repro_torch.telemetry.profile import profile_phase
        return profile_phase(name, **args)
    if sess.tracer is None:
        return _null_span()
    return sess.tracer.span(name, **args)
