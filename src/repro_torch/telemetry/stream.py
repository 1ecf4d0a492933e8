"""Telemetry session + the device metrics tap (port of
``repro.telemetry.stream``).

One process-wide :class:`TelemetrySession` (opened by an engine from
``GFLConfig.telemetry``, or explicitly by :func:`session`) owns the sinks
and the span tracer.  There are two ways a record reaches it:

* :func:`emit` — host code, host values.  A tensor value is read once
  (``.item()`` / ``.tolist()``), so :func:`emit` syncs with the device and
  raises when called while a CUDA stream is capturing: a captured round
  may not sync with the host.  (:func:`note` takes records made only of
  host values known at dispatch, the ``kernel`` stream's, and is legal
  anywhere.)
* :class:`MetricsStream` — the in-graph tap.  The reference flushes traced
  values through ``jax.experimental.io_callback`` from inside its jitted
  bodies; a CUDA graph has no host callback, so here the tap is a device
  buffer ``[T, F]`` (float32) made once a run.  The round body writes its
  row at the device round counter (``index_copy_``, as the round graph
  already writes the MSD), or the engine fills a column from a [T] trace
  it already keeps; after the run :meth:`MetricsStream.drain` reads the
  buffer once and ingests its rows in order.  Running totals
  (``cumulative``) are computed on the device at the drain, as running
  sums of their source column.

Hard contract: with no session active nothing is allocated and a round
has no extra op — engines make a :class:`MetricsStream` only when
:func:`telemetry_active`, so the off-path round graph is the
uninstrumented one, op for op and bit for bit.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.telemetry.schema import get_schema, validate_record
from repro_torch.telemetry.sinks import MemorySink, Sink, sink_from_spec
from repro_torch.telemetry.trace import SpanTracer

ENV_FLAG = "REPRO_TELEMETRY"
ENV_FLUSH_EVERY = "REPRO_TELEMETRY_FLUSH_EVERY"
ENV_PROFILE = "REPRO_TELEMETRY_PROFILE"
_OFF = ("", "off", "none", "0")

_SESSION: Optional["TelemetrySession"] = None


class TelemetrySession:
    """Owns the sinks + tracer of one telemetry-enabled run scope.

    Safe to write from several threads (the fleet's in-process workers
    record their ``kernel`` records beside the coordinator's ``fleet``
    ones): the sequence, the sinks and ``kernels_seen`` are updated under
    one lock."""

    def __init__(self, sinks: List[Sink], tracer: Optional[SpanTracer] = None,
                 run_id: Optional[str] = None,
                 profile: Optional[bool] = None):
        self.sinks = list(sinks)
        self.tracer = tracer
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        self.records = 0
        self._seq = 0
        # host seconds spent draining and ingesting records — the phase
        # profiler reports it as callback_s
        self.callback_seconds = 0.0
        # (op, shape, layout, mode) keys the kernel stream has recorded
        self.kernels_seen: set = set()
        self._lock = threading.Lock()
        if profile is None:
            profile = os.environ.get(ENV_PROFILE, "0") \
                not in ("", "0", "false")
        self.profile = bool(profile)

    def next_seq(self) -> int:
        """Monotone per-session sequence number (the ``kernel`` and
        ``profile`` streams' index)."""
        with self._lock:
            self._seq += 1
            return self._seq

    def claim(self, key: tuple) -> bool:
        """True the first time ``key`` is claimed this session (the
        ``kernel`` stream's once-per-shape record), False after."""
        with self._lock:
            if key in self.kernels_seen:
                return False
            self.kernels_seen.add(key)
            return True

    def _write(self, stream: str, record: Mapping) -> None:
        rec = {"stream": stream, "run": self.run_id,
               "t_wall": time.time(), **record}
        with self._lock:
            for sink in self.sinks:
                sink.write(rec)
            self.records += 1

    def ingest(self, stream: str, record: Mapping) -> None:
        t0 = time.perf_counter()
        self._write(stream, record)
        with self._lock:
            self.callback_seconds += time.perf_counter() - t0

    def memory_records(self, stream: Optional[str] = None) -> List[dict]:
        """Records captured by any MemorySink (tests / tail views)."""
        out: List[dict] = []
        for sink in self.sinks:
            if isinstance(sink, MemorySink):
                out.extend(sink.records if stream is None
                           else sink.by_stream(stream))
        return out

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()
        if self.tracer is not None:
            self.tracer.save()


def current_session() -> Optional[TelemetrySession]:
    return _SESSION


def telemetry_active() -> bool:
    return _SESSION is not None


def capturing() -> bool:
    """True while the current CUDA stream is capturing a graph."""
    import torch
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _to_py(value):
    """tensor / numpy / python value -> plain python for the record."""
    if hasattr(value, "detach"):
        value = value.detach().cpu()
    if getattr(value, "ndim", 0) > 0:
        return [_to_py(v) for v in value.tolist()]
    if hasattr(value, "item"):
        value = value.item()
    if isinstance(value, bool):
        return int(value)
    return value


def emit(stream: str, values: Mapping) -> None:
    """Emit one record from host code to the active session (no-op when
    none).  Keys are validated against the stream's schema; tensor values
    are read once.  Raises under CUDA-graph capture: a captured round
    may not sync with the host (write into a :class:`MetricsStream`
    instead)."""
    sess = _SESSION
    if sess is None:
        return
    if capturing():
        raise RuntimeError(
            f"telemetry emit({stream!r}) while a CUDA stream is capturing: "
            "a captured round may not sync with the host — write into a "
            "MetricsStream buffer and drain it after the run")
    vals = dict(values)
    validate_record(stream, vals)
    sess.ingest(stream, {k: _to_py(v) for k, v in vals.items()})


def note(stream: str, values: Mapping) -> None:
    """Record host values known at dispatch (Python scalars and strings,
    never a tensor) — legal under capture, since it reads nothing from the
    device.  The ``kernel`` stream's records come this way."""
    sess = _SESSION
    if sess is None:
        return
    vals = dict(values)
    validate_record(stream, vals)
    for k, v in vals.items():
        if hasattr(v, "detach"):
            raise TypeError(f"note({stream!r}): {k} is a tensor; use emit")
    sess.ingest(stream, vals)


def flush_every_from_env(default: int = 1) -> int:
    """The ``REPRO_TELEMETRY_FLUSH_EVERY`` batching knob (>= 1)."""
    try:
        n = int(os.environ.get(ENV_FLUSH_EVERY, "") or default)
    except ValueError:
        n = default
    return max(1, n)


class MetricsStream:
    """A device buffer of one stream's rows, written by a run and drained
    after it.

    ``fields`` are the record's fields (scalar and int kinds only: the
    buffer is float32, exact for counts below 2^24).  The stream's index
    field (``step`` / ``round``) is not stored: row ``i``'s index is
    ``start + i``.  ``cumulative`` maps a running-total field to the
    column it sums (a bare tuple sums each field into itself); totals are
    computed at the drain.  Engines build one only when a session is
    active::

        ms = MetricsStream("step", ("step", "update_norm", "param_norm"),
                           length=T, device=dev)
        # inside the round body (captured or eager), at the device counter:
        ms.tap(counter, {"update_norm": un, "param_norm": pn})
        # or, after the run, from a [T] trace the engine keeps anyway:
        ms.load("msd", msd)
        ms.drain()

    ``flush_every`` (default ``REPRO_TELEMETRY_FLUSH_EVERY``, else 1) is
    how many rows go to the sinks per batch at the drain; every row is
    delivered either way."""

    def __init__(self, stream: str, fields: Tuple[str, ...], *, length: int,
                 device=None,
                 cumulative: Mapping[str, str] | Tuple[str, ...] = (),
                 flush_every: Optional[int] = None, start: int = 1):
        import torch
        self.stream = stream
        schema = get_schema(stream)
        allowed = schema.field_map()
        if not isinstance(cumulative, Mapping):
            cumulative = {name: name for name in cumulative}
        self.cumulative = dict(cumulative)
        self.fields = tuple(fields)
        for name in self.fields + tuple(self.cumulative):
            if name not in allowed:
                raise KeyError(f"field {name!r} not in stream {stream!r} "
                               "schema")
            if allowed[name].kind not in ("scalar", "int"):
                raise ValueError(
                    f"field {name!r} has kind {allowed[name].kind!r}; only "
                    "scalar/int rows fit the device buffer")
        for total, source in self.cumulative.items():
            if source not in self.fields:
                raise KeyError(f"cumulative field {total!r} sums "
                               f"{source!r}, which is not a field")
        self.index = schema.index
        self.kinds = {name: allowed[name].kind for name in self.fields}
        self.columns_stored = tuple(name for name in self.fields
                                    if name != self.index
                                    and name not in self.cumulative)
        self._col = {name: j for j, name in enumerate(self.columns_stored)}
        self.length, self.start = int(length), int(start)
        if flush_every is None:
            flush_every = flush_every_from_env()
        self.flush_every = max(1, int(flush_every))
        self.buf = torch.zeros((self.length, len(self.columns_stored)),
                               dtype=torch.float32, device=device)

    def tap(self, at, values: Mapping) -> None:
        """Write one row (0-d tensors for every stored column) at ``at``:
        a [1] int64 device counter (the round graph's) or a Python int.
        Device ops only: legal inside a captured round."""
        import torch
        if set(values) != set(self.columns_stored):
            raise ValueError(
                f"tap row fields {sorted(values)} != the stream's stored "
                f"fields {sorted(self.columns_stored)}")
        row = torch.stack([values[name].reshape(()).to(torch.float32)
                           for name in self.columns_stored])
        if isinstance(at, int):
            self.buf[at].copy_(row)
        else:
            self.buf.index_copy_(0, at, row[None])

    def load(self, name: str, column) -> None:
        """Fill column ``name`` from a [length] device trace (after the
        run, never inside a captured round)."""
        self.buf[:, self._col[name]].copy_(column.reshape(-1))

    def columns(self) -> Dict[str, "object"]:
        """{field: numpy [length]} — the buffer read once, running totals
        summed on the device first, the index field from the position."""
        import numpy as np
        import torch
        parts = [self.buf]
        for source in self.cumulative.values():
            j = self._col[source]
            parts.append(torch.cumsum(self.buf[:, j], 0)[:, None])
        host = torch.cat(parts, dim=1).cpu().numpy()
        names = self.columns_stored + tuple(self.cumulative)
        out: Dict[str, object] = {name: host[:, j]
                                  for j, name in enumerate(names)}
        if self.index in self.fields:
            out[self.index] = np.arange(self.start, self.start + self.length)
        return {name: out[name] for name in self.fields}

    def rows(self) -> List[dict]:
        """The buffer's records, in order, as plain Python values."""
        cols = self.columns()
        out = []
        for i in range(self.length):
            rec = {}
            for name in self.fields:
                v = cols[name][i]
                rec[name] = (int(round(float(v)))
                             if self.kinds[name] == "int" else float(v))
            out.append(rec)
        return out

    def drain(self) -> int:
        """Read the buffer once and ingest its rows in order, in batches
        of ``flush_every``; a no-op with no session.  Returns the rows
        delivered."""
        sess = _SESSION
        if sess is None:
            return 0
        t0 = time.perf_counter()
        rows = self.rows()
        for lo in range(0, len(rows), self.flush_every):
            for rec in rows[lo:lo + self.flush_every]:
                sess._write(self.stream, rec)
        with sess._lock:
            sess.callback_seconds += time.perf_counter() - t0
        return len(rows)


# ---------------------------------------------------------------------------
# session lifecycle
# ---------------------------------------------------------------------------


def _trace_path_for(sinks: List[Sink]):
    """Default trace-JSON path: beside the first file-backed sink, else
    under the default telemetry dir."""
    from pathlib import Path

    from repro_torch.telemetry.sinks import CsvSink, JsonlSink
    for sink in sinks:
        if isinstance(sink, JsonlSink):
            return sink.path.with_suffix(".trace.json")
        if isinstance(sink, CsvSink):
            return sink.base.with_suffix(".trace.json")
    return Path(os.environ.get("REPRO_TELEMETRY_DIR",
                               "telemetry_out")) / "run.trace.json"


@contextmanager
def session(spec_or_sinks="memory", *, trace_path=None,
            run_id: Optional[str] = None,
            profile: Optional[bool] = None):
    """Open a telemetry session for a ``with`` scope.

    ``spec_or_sinks``: a ``+``-separated sink spec string
    (``"jsonl:runs/a.jsonl+console"``) or an explicit list of
    :class:`~repro_torch.telemetry.sinks.Sink` objects.  Nesting is a
    no-op passthrough: an inner engine-opened session never shadows an
    outer one, so records from nested executors land in one stream.
    """
    global _SESSION
    if _SESSION is not None:           # outer session wins; reuse it
        yield _SESSION
        return
    if isinstance(spec_or_sinks, str):
        sinks = [sink_from_spec(part)
                 for part in spec_or_sinks.split("+") if part]
    else:
        sinks = list(spec_or_sinks)
    tracer = SpanTracer(trace_path if trace_path is not None
                        else _trace_path_for(sinks))
    sess = TelemetrySession(sinks, tracer, run_id, profile=profile)
    _SESSION = sess
    try:
        yield sess
    finally:
        _SESSION = None
        sess.close()


def config_spec(cfg=None) -> str:
    """The effective telemetry spec of a run: the config field when set,
    else the ``REPRO_TELEMETRY`` env override, else ``"off"``."""
    spec = getattr(cfg, "telemetry", "off") if cfg is not None else "off"
    if spec in _OFF:
        spec = os.environ.get(ENV_FLAG, "off")
    return spec or "off"


def session_from_config(cfg=None):
    """Context manager for an engine run: opens a session per
    ``cfg.telemetry`` / ``REPRO_TELEMETRY`` — or a passthrough
    nullcontext when telemetry is off or an outer session is already
    active (the bit-identity off path)."""
    spec = config_spec(cfg)
    if spec in _OFF or _SESSION is not None:
        return nullcontext(_SESSION)
    return session(spec)
