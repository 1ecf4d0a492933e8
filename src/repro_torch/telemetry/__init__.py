"""Unified telemetry: schema'd metric streams, span tracing, run logs (port
of ``repro.telemetry``).

Public surface:

* :func:`emit` / :class:`MetricsStream` — record emission from host code,
  and from inside a (captured) round body through a device buffer drained
  after the run.
* :func:`session` / :func:`session_from_config` — open the process-wide
  telemetry session; ``telemetry=off`` (the default) is bit-identical to
  an uninstrumented run, with the same round graph.
* :func:`trace_span` — Chrome/Perfetto span tracing of host-side phases.
* :class:`RunLog` — per-round record list engines expose their result
  fields as views over.
* :class:`Schema` registry — every stream's fields, validated at emit.
* :class:`QuantileSketch` — mergeable quantile summaries (inspector).

``python -m repro_torch.telemetry.inspect RUN.jsonl`` summarizes a run;
``python -m repro_torch.telemetry.watch RUN.jsonl --once`` judges it.
"""
from repro_torch.telemetry.profile import profile_phase
from repro_torch.telemetry.runlog import RunLog
from repro_torch.telemetry.schema import (Field, Schema, SchemaError,
                                          get_schema, list_schemas,
                                          register_schema, validate_record)
from repro_torch.telemetry.sinks import (ConsoleSink, CsvSink, JsonlSink,
                                         MemorySink, Sink, sink_from_spec)
from repro_torch.telemetry.sketch import QuantileSketch
from repro_torch.telemetry.stream import (MetricsStream, TelemetrySession,
                                          current_session, emit,
                                          flush_every_from_env, session,
                                          session_from_config,
                                          telemetry_active)
from repro_torch.telemetry.trace import SpanTracer, trace_span
from repro_torch.telemetry.watch import WatchRule, Watcher, parse_watch_spec

__all__ = [
    "ConsoleSink", "CsvSink", "Field", "JsonlSink", "MemorySink",
    "MetricsStream", "QuantileSketch", "RunLog", "Schema", "SchemaError",
    "Sink", "SpanTracer", "TelemetrySession", "WatchRule", "Watcher",
    "current_session", "emit", "flush_every_from_env", "get_schema",
    "list_schemas", "parse_watch_spec", "profile_phase", "register_schema",
    "session", "session_from_config", "sink_from_spec", "telemetry_active",
    "trace_span", "validate_record",
]
