"""The benchmark's traced window and its reduction.

:class:`Spans` records host spans around the benchmark's own calls into
each layer of the program: their seconds, and their intervals on the
wall clock the profiler stamps its records with.  :func:`traced` runs a
block under ``torch.profiler`` with the device's activity alone (host
operations recorded one by one would slow the host several-fold and show
a card idle that is not), padded with host idle time at each end so that
the profiler's start and stop stay out of the block, and reduces the
trace to a :class:`Trace`: the device operations (kernels, copies, fills)
with their times, the busy time (the union of their intervals), the
window (the block's host time, its final synchronize included) and the
idle gaps, each labelled by the innermost span running when it began.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

PAD_S = 0.05


def short(name: str, width: int = 160) -> str:
    """A device operation's name without ``void `` and cut to ``width``
    characters: a templated kernel's full name runs to thousands."""
    return name.removeprefix("void ")[:width]


class Spans:
    """Host spans by name: the seconds of each occurrence, and each
    occurrence's (name, start, end) in wall-clock nanoseconds."""

    def __init__(self):
        self.seconds: dict = defaultdict(list)
        self.intervals: list = []

    @contextmanager
    def __call__(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)
            self.intervals.append((name, w0, time.time_ns(), True))


@dataclass
class Trace:
    window_s: float
    ops: list                      # (name, start_ns, end_ns) on the device
    host: list                     # (name, start_ns, end_ns, is_span):
                                   # the spans of the window
    units: int = 0                 # the driver's units inside the window

    @property
    def busy_s(self) -> float:
        busy, end = 0, None
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def time_by_name(self) -> dict:
        out: dict = defaultdict(float)
        for name, s, e in self.ops:
            out[name] += (e - s) * 1e-9
        return dict(out)

    def seconds_matching(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts``."""
        return sum(t for name, t in self.time_by_name().items()
                   if any(p in name for p in parts))

    def gaps(self) -> list:
        """(label, seconds) of every idle stretch between device
        operations, the label the innermost span and host op running when
        the stretch began (the latest-begun of each still running)."""
        host = sorted(self.host, key=lambda h: h[1])
        heaps: tuple = ([], [])            # (-start, end, name): ops, spans
        out, end, j = [], None, 0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                while j < len(host) and host[j][1] <= end:
                    name, hs, he, is_span = host[j]
                    heapq.heappush(heaps[is_span], (-hs, he, name))
                    j += 1
                label = []
                for heap in reversed(heaps):
                    while heap and heap[0][1] < end:
                        heapq.heappop(heap)
                    if heap:
                        label.append(heap[0][2])
                out.append(("/".join(label) or "host idle",
                            (s - end) * 1e-9))
            end = e if end is None else max(end, e)
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten
        longest idle gaps, each merged by name."""
        gaps: dict = defaultdict(float)
        for label, sec in self.gaps():
            gaps[label] += sec
        ops: dict = defaultdict(float)
        for name, sec in self.time_by_name().items():
            ops[short(name)] += sec
        top = sorted(ops.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, t] for n, t in top[:10]],
                "idle_gaps": [[n, t] for n, t in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}


def traced(block, spans: Spans) -> tuple:
    """(block's value, :class:`Trace`) of ``block()`` under the profiler
    (the host's activity instead where there is no card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    first = len(spans.intervals)
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        value = block()
        sync()
        window = time.perf_counter() - t0
        time.sleep(PAD_S)
    ops = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and \
                not e.is_user_annotation():
            start = e.start_ns()
            ops.append((e.name(), start, start + e.duration_ns()))
    return value, Trace(window, ops, spans.intervals[first:])
