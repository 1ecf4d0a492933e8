"""Event-driven async engine: buffered, staleness-weighted aggregation
over the server graph (port of ``repro.core.events``).  See docs/async.md."""
from repro_torch.core.events.buffer import (
    BufferedServerState,
    fold_tick,
    flush,
    init_buffers,
    staleness_weights,
    weighted_fold,
)
from repro_torch.core.events.engine import (
    AsyncCohortDriver,
    AsyncRunResult,
    AsyncState,
    run_gfl_async,
)
from repro_torch.core.events.queue import EventQueue, trace_intensity_fn
from repro_torch.core.events.spec import (
    AsyncSpec,
    LatencySpec,
    parse_async_spec,
    parse_latency_spec,
)

__all__ = [
    "AsyncCohortDriver", "AsyncRunResult", "AsyncSpec", "AsyncState",
    "BufferedServerState", "EventQueue", "LatencySpec", "fold_tick",
    "flush", "init_buffers", "parse_async_spec", "parse_latency_spec",
    "run_gfl_async", "staleness_weights", "trace_intensity_fn",
    "weighted_fold",
]
