"""Telemetry schema registry: every metrics stream declares its fields (a
copy of ``repro.telemetry.schema``, the same streams and field names).

A :class:`Schema` names one record stream (``round``, ``step``,
``privacy``, ``kernel``, ``mesh``) and the fields records of that stream
may carry.  Emission validates against the registry at the emit site —
for the device taps when their buffer is made, before the round is
captured, so a typo'd field name fails loudly rather than producing a
silently malformed JSONL — and the inspector CLI validates again on
read, so a run's record stream is self-describing end to end (the
reference's docs/observability.md has the full schema table).

Field kinds:

``scalar``   one float (numpy / 0-d tensor scalars accepted, serialized
             as float)
``int``      one integer (counters, indices; bools serialize as 0/1)
``str``      a short tag (engine name, op name, backend)
``series``   a small 1-D array (per-server vectors), serialized as a list

Every stream declares exactly one required ``index`` field (the round /
tick / step the record belongs to); all other fields are optional so the
three engines can share one ``round`` schema while emitting only what
their execution mode realizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

KINDS = ("scalar", "int", "str", "series")


class SchemaError(ValueError):
    """A record does not match its stream's registered schema."""


@dataclass(frozen=True)
class Field:
    name: str
    kind: str = "scalar"
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise SchemaError(f"unknown field kind {self.kind!r} for "
                              f"{self.name!r}; expected one of {KINDS}")


@dataclass(frozen=True)
class Schema:
    """One record stream: a name, an index field and the allowed fields."""
    stream: str
    index: str                  # required per-record position field
    fields: Tuple[Field, ...]
    description: str = ""

    def field_map(self) -> Dict[str, Field]:
        return {f.name: f for f in self.fields}

    def validate(self, record: Mapping) -> None:
        """Raise :class:`SchemaError` on unknown fields or a missing
        index.  Values are NOT type-coerced here — in-graph emission
        validates keys at trace time when values are still tracers."""
        allowed = self.field_map()
        for key in record:
            if key not in allowed:
                raise SchemaError(
                    f"stream {self.stream!r} has no field {key!r}; "
                    f"registered fields: {sorted(allowed)}")
        if self.index not in record:
            raise SchemaError(f"stream {self.stream!r} record is missing "
                              f"its index field {self.index!r}")


_REGISTRY: Dict[str, Schema] = {}


def register_schema(schema: Schema) -> Schema:
    """Register (or deliberately replace) a stream schema."""
    _REGISTRY[schema.stream] = schema
    return schema


def get_schema(stream: str) -> Schema:
    try:
        return _REGISTRY[stream]
    except KeyError:
        raise SchemaError(f"unknown telemetry stream {stream!r}; "
                          f"registered: {sorted(_REGISTRY)}") from None


def list_schemas() -> Dict[str, Schema]:
    return dict(_REGISTRY)


def validate_record(stream: str, record: Mapping) -> None:
    get_schema(stream).validate(record)


# ---------------------------------------------------------------------------
# built-in streams (the schema table in the reference's
# docs/observability.md)
# ---------------------------------------------------------------------------

register_schema(Schema(
    "round", index="round", description=(
        "per-round executor record, one per protocol round/tick "
        "(host-side; all three engines emit it)"),
    fields=(
        Field("round", "int", "protocol round / tick index"),
        Field("engine", "str", "dense | population | async"),
        Field("msd", "scalar", "centroid MSD vs w_ref"),
        Field("q", "scalar", "realized cohort sampling rate"),
        Field("cohort", "int", "sampled cohort size L (events folded E)"),
        Field("gap", "scalar", "realized spectral gap of A_i"),
        Field("staleness", "series", "per-server staleness (psi age / "
                                     "mean folded age)"),
        Field("grad_norm_mean", "scalar", "mean clipped grad norm"),
        Field("grad_norm_max", "scalar", "max clipped grad norm"),
        Field("fold_mass", "scalar", "total fold-weight mass this round"),
        Field("flushed", "series", "per-server flush indicator"),
        Field("events", "series", "per-server valid arrivals folded"),
        Field("dropped_stale", "series", "per-server over-stale refusals"),
        Field("buffer", "series", "per-server buffer occupancy"),
        Field("q_server", "series", "per-server realized flush q"),
    )))

register_schema(Schema(
    "step", index="step", description=(
        "per-step tap written into a device buffer inside the round "
        "(graph) body and drained after the run (read-only; absent "
        "when telemetry is off)"),
    fields=(
        Field("step", "int", "engine step counter"),
        Field("msd", "scalar", "centroid MSD vs w_ref"),
        Field("update_norm", "scalar", "||params_new - params_old||"),
        Field("param_norm", "scalar", "||params_new||"),
        Field("flushed", "int", "servers flushed this tick"),
        Field("events", "int", "valid arrivals folded this tick"),
        Field("events_total", "scalar", "cumulative arrivals folded "
                                        "(MetricsStream carry)"),
        Field("dropped", "int", "over-stale arrivals refused"),
        Field("staleness", "scalar", "mean folded age"),
        Field("fold_mass", "scalar", "total fold-weight mass"),
    )))

register_schema(Schema(
    "privacy", index="step", description=(
        "one record per accountant release charge "
        "(PrivacyAccountant.advance)"),
    fields=(
        Field("step", "int", "ledger step (releases charged so far)"),
        Field("eps", "scalar", "composed epsilon (unamplified curve)"),
        Field("eps_release", "scalar", "this release's epsilon"),
        Field("eps_release_amp", "scalar",
              "this release's subsampling-amplified epsilon"),
        Field("delta", "scalar", "composed delta spent"),
        Field("q", "scalar", "realized sampling rate of this release"),
        Field("curve", "str", "accountant curve"),
        Field("server", "str", "owning ledger tag ('' = scalar ledger)"),
    )))

register_schema(Schema(
    "kernel", index="seq", description=(
        "kernel-dispatch record: backend chosen, analytic HBM traffic "
        "(emitted host-side at dispatch, once per (op, shape, layout, "
        "mode) a session)"),
    fields=(
        Field("seq", "int", "dispatch sequence number"),
        Field("op", "str", "kernel op name"),
        Field("backend", "str", "cuda | plain"),
        Field("block_d", "int", "chosen model-dim block (unused: the "
                                  "port's launch is fixed)"),
        Field("d_pad", "int", "model dim (the port pads nothing)"),
        Field("interpret", "int", "1 when running the plain version"),
        Field("autotuned", "int", "1 when candidates were timed (never)"),
        Field("mode", "str", "client noise mode (round_fold)"),
        Field("hbm_bytes", "scalar", "analytic fused HBM bytes "
                                     "(roofline.round_pipeline_traffic)"),
        Field("hbm_bytes_ref", "scalar", "analytic reference-chain bytes"),
        Field("pld_passes", "int", "gradient-scale HBM round trips"),
    )))

register_schema(Schema(
    "mesh", index="step", description="mesh trainer per-step record "
                                      "(launch/train.py)",
    fields=(
        Field("step", "int", "training step"),
        Field("loss", "scalar", "mean training loss"),
        Field("seconds", "scalar", "wall-clock seconds since t0"),
        Field("gap", "scalar", "realized spectral gap (fault runs)"),
    )))

register_schema(Schema(
    "fleet", index="tick", description=(
        "per-tick fleet coordinator record (core/fleet): worker "
        "liveness, delivery retries, elastic restarts and transport "
        "replay lag — the resilience counters of a multi-process run"),
    fields=(
        Field("tick", "int", "coordinator dispatch tick"),
        Field("heartbeat_age", "series", "per-server seconds since the "
                                         "last heartbeat"),
        Field("retries", "int", "cumulative send/collect retries"),
        Field("restarts", "int", "cumulative elastic worker restarts"),
        Field("replay_lag", "int", "coordinator transport backlog "
                                   "(records logged/queued but unread)"),
        Field("down", "series", "per-server down indicator this tick"),
        Field("flushes", "int", "servers that flushed this tick"),
        Field("msd", "scalar", "centroid MSD vs w_ref"),
    )))

register_schema(Schema(
    "profile", index="seq", description=(
        "phase-level profiler record (telemetry/profile.py): wall time "
        "attributed to compile vs execute vs host callbacks per "
        "trace_span phase, graph-capture / nvcc-build counters, device "
        "memory watermark"),
    fields=(
        Field("seq", "int", "profiler sequence number (session-monotone)"),
        Field("phase", "str", "trace_span phase name"),
        Field("wall_s", "scalar", "phase wall-clock seconds"),
        Field("compile_s", "scalar", "round-graph warm-up + capture and "
                                     "nvcc build seconds inside the phase"),
        Field("execute_s", "scalar", "wall minus compile minus callback "
                                     "(device execute + host driver)"),
        Field("callback_s", "scalar", "host seconds draining and "
                                      "ingesting telemetry records"),
        Field("retraces", "int", "CUDA-graph captures of a graph key new "
                                 "to the process, inside the phase"),
        Field("compiles", "int", "nvcc kernel builds inside the phase"),
        Field("peak_bytes", "scalar", "torch.cuda.max_memory_allocated "
                                      "after the phase (absent on the "
                                      "CPU)"),
    )))
