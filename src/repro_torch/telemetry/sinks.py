"""Pluggable telemetry sinks: where flushed records land (a copy of
``repro.telemetry.sinks``).

Every sink consumes the same enveloped record dict (``stream``, ``run``,
``t_wall`` plus the schema'd fields) — the JSONL sink is the canonical
on-disk format the inspector CLI reads; CSV writes one file per stream
(records of different streams have different columns); the memory sink
backs tests and the run-result views; the console sink renders a live
table (rich when available, aligned plain text otherwise).
"""
from __future__ import annotations

import csv
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional


def _jsonable(value):
    """Record values -> JSON-ready python (lists for series, floats for
    numpy scalars).  Non-finite floats stay as-is: ``json`` round-trips
    them as Infinity/NaN literals, and eps = inf is a meaningful ledger
    state (a zero-noise mechanism), not an error."""
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "item"):
        return value.item()
    return value


class Sink:
    """Base sink: ``write`` one enveloped record, ``close`` when the
    session ends."""

    def write(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keeps records in a list — tests and the inspector's tail mode."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def by_stream(self, stream: str) -> List[dict]:
        return [r for r in self.records if r.get("stream") == stream]


class JsonlSink(Sink):
    """One JSON object per line — the canonical run-record format
    (``python -m repro_torch.telemetry.inspect`` reads it)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "w", encoding="utf-8")

    def write(self, record: dict) -> None:
        self._fh.write(json.dumps(
            {k: _jsonable(v) for k, v in record.items()}) + "\n")

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()


class CsvSink(Sink):
    """One CSV file per stream (``<base>.<stream>.csv``): streams have
    different columns, so a single flat file would be mostly holes.
    Columns are fixed by the stream's registered schema order."""

    def __init__(self, base_path):
        self.base = Path(base_path)
        self.base.parent.mkdir(parents=True, exist_ok=True)
        self._writers: Dict[str, tuple] = {}

    def _writer(self, stream: str):
        if stream not in self._writers:
            from repro_torch.telemetry.schema import get_schema
            cols = (["run", "t_wall"]
                    + [f.name for f in get_schema(stream).fields])
            path = self.base.with_name(
                f"{self.base.stem}.{stream}.csv")
            fh = open(path, "w", newline="", encoding="utf-8")
            w = csv.DictWriter(fh, fieldnames=cols, extrasaction="ignore")
            w.writeheader()
            self._writers[stream] = (fh, w)
        return self._writers[stream][1]

    def write(self, record: dict) -> None:
        stream = record.get("stream", "")
        row = {k: _jsonable(v) for k, v in record.items() if k != "stream"}
        for k, v in row.items():
            if isinstance(v, list):
                row[k] = json.dumps(v)
        self._writer(stream).writerow(row)

    def close(self) -> None:
        for fh, _ in self._writers.values():
            fh.flush()
            fh.close()


class ConsoleSink(Sink):
    """Live run table on stderr: one line per ``every`` records of the
    watched stream (default: every record of ``round``).  Uses rich when
    importable, column-aligned plain text otherwise — never a hard dep."""

    _COLS = ("round", "engine", "msd", "q", "gap", "cohort")

    def __init__(self, every: int = 1, stream: str = "round", file=None):
        self.every = max(1, int(every))
        self.stream = stream
        self.file = file or sys.stderr
        self._seen = 0
        self._header_done = False
        try:                                     # optional pretty renderer
            from rich.console import Console
            self._console: Optional[object] = Console(
                file=self.file, force_terminal=False)
        except ImportError:
            self._console = None

    def _fmt(self, record: dict) -> str:
        parts = []
        for col in self._COLS:
            v = record.get(col, "")
            if isinstance(v, float):
                v = f"{v:.4g}"
            parts.append(f"{str(v):>10.10}")
        return "  ".join(parts)

    def write(self, record: dict) -> None:
        if record.get("stream") != self.stream:
            return
        self._seen += 1
        if self._seen % self.every:
            return
        if not self._header_done:
            header = "  ".join(f"{c:>10.10}" for c in self._COLS)
            self._emit_line(header)
            self._emit_line("-" * len(header))
            self._header_done = True
        self._emit_line(self._fmt(record))

    def _emit_line(self, line: str) -> None:
        if self._console is not None:
            self._console.print(line, highlight=False)
        else:
            print(line, file=self.file)


def sink_from_spec(spec: str) -> Sink:
    """Build one sink from a ``kind[:arg]`` spec component.

    ``jsonl[:path]`` | ``csv[:base]`` | ``memory`` | ``console[:every]``.
    Default paths land under ``$REPRO_TELEMETRY_DIR`` (default
    ``telemetry_out/``) so bare ``--telemetry jsonl`` works out of the
    box.
    """
    kind, _, arg = spec.partition(":")
    outdir = Path(os.environ.get("REPRO_TELEMETRY_DIR", "telemetry_out"))
    if kind == "jsonl":
        return JsonlSink(arg or outdir / "run.jsonl")
    if kind == "csv":
        return CsvSink(arg or outdir / "run.csv")
    if kind == "memory":
        return MemorySink()
    if kind == "console":
        return ConsoleSink(every=int(arg) if arg else 1)
    raise ValueError(f"unknown telemetry sink spec {spec!r}; expected "
                     "jsonl[:path] | csv[:base] | memory | console[:every]")
