"""RunLog: the per-round record list behind engine run results (a copy of
``repro.telemetry.runlog``).

Engines used to keep ad-hoc parallel lists (``gaps``, ``msd_rounds``,
``flush history``...) and stack them into NamedTuple fields at the end.
A :class:`RunLog` replaces those lists with one list of per-round record
dicts: each appended row is simultaneously (a) forwarded to the active
telemetry session's ``round`` stream (no-op when telemetry is off) and
(b) kept for the legacy result fields, which become :meth:`column` /
:meth:`stack` views over the same rows — so ``PopulationRunResult.gaps``
and the telemetry JSONL can never disagree.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.telemetry.stream import emit


class RunLog:
    """Ordered per-round records of one engine run."""

    def __init__(self, engine: str, stream: str = "round"):
        self.engine = engine
        self.stream = stream
        self.rows: List[Dict] = []

    def __len__(self) -> int:
        return len(self.rows)

    def row(self, round: int, **values) -> Dict:
        """Append one per-round record and forward it to telemetry.

        ``None`` values are dropped (a field the execution mode didn't
        realize); everything else must be a host value (engines log from
        the host loop or post-scan)."""
        rec: Dict = {"round": int(round), "engine": self.engine}
        for k, v in values.items():
            if v is not None:
                rec[k] = v
        self.rows.append(rec)
        emit(self.stream, rec)
        return rec

    def extend_arrays(self, arrays: Mapping[str, Sequence], *,
                      start: int = 0) -> None:
        """Bulk-append rows from stacked per-round arrays (the scan
        paths produce whole-run arrays, not a host loop).  All arrays
        must share their leading length; row ``i`` gets round
        ``start + i``."""
        lengths = {len(a) for a in arrays.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged run-log arrays: lengths {lengths}")
        n = lengths.pop() if lengths else 0
        for i in range(n):
            self.row(start + i, **{k: _host(a[i]) for k, a in arrays.items()})

    # -- legacy-field views ------------------------------------------------

    def column(self, field: str, default=None) -> List:
        return [r.get(field, default) for r in self.rows]

    def stack(self, field: str) -> Optional[np.ndarray]:
        """Rows' ``field`` stacked into one array (None when no row has
        it — the legacy 'history not recorded' value)."""
        vals = [r[field] for r in self.rows if field in r]
        if not vals:
            return None
        return np.stack([np.asarray(v) for v in vals])


def _host(value):
    """Per-element coercion for extend_arrays rows: 0-d -> python
    scalar, 1-d stays an array (series fields)."""
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr.item()
    return arr
