"""Deterministic mergeable quantile sketch (KLL-style).

The inspector summarizes per-metric p50/p99 across arbitrarily long
JSONL streams without holding every value; shards of a run (or several
runs) merge associatively.  The classic KLL compactor discards odd- or
even-indexed items by coin flip; here the coin is a per-level toggle, so
the sketch is fully deterministic — same inputs (in the same order) give
the same summary, which keeps tests and BENCH comparisons reproducible.
The price is a deterministic (rather than randomized) rank error, still
bounded by the compaction weights: each level-``i`` compaction moves at
most ``k/2`` items of weight ``2**i``, and a level is compacted at most
once per promotion, so the absolute rank error after ``n`` inserts is
``O((n/k) * log2(n/k))`` — tests/test_torch_telemetry.py checks the realized
error against ``numpy.percentile`` on adversarial inputs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple


class QuantileSketch:
    """Mergeable quantile summary over streamed floats.

    ``k`` is the per-level compactor capacity: bigger k, lower rank
    error, more memory (total memory is O(k log(n/k))).
    """

    def __init__(self, k: int = 128):
        if k < 4:
            raise ValueError("k must be >= 4")
        self.k = int(k)
        self._levels: List[List[float]] = [[]]
        self._coins: List[bool] = [False]
        self.count = 0
        self._min = float("inf")
        self._max = float("-inf")

    # -- ingestion ---------------------------------------------------------

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        self._levels[0].append(v)
        if len(self._levels[0]) >= self.k:
            self._compact()

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def _compact(self) -> None:
        for lvl in range(len(self._levels)):
            buf = self._levels[lvl]
            if len(buf) < self.k:
                continue
            buf.sort()
            # deterministic coin: alternate keeping odd/even-indexed items
            start = 1 if self._coins[lvl] else 0
            self._coins[lvl] = not self._coins[lvl]
            promoted = buf[start::2]
            self._levels[lvl] = []
            if lvl + 1 == len(self._levels):
                self._levels.append([])
                self._coins.append(False)
            self._levels[lvl + 1].extend(promoted)

    # -- merging -----------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch (in place; also returned)."""
        if other.count == 0:
            return self
        while len(self._levels) < len(other._levels):
            self._levels.append([])
            self._coins.append(False)
        for lvl, buf in enumerate(other._levels):
            self._levels[lvl].extend(buf)
        self.count += other.count
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        # restore capacity invariant bottom-up
        changed = True
        while changed:
            changed = False
            for lvl in range(len(self._levels)):
                if len(self._levels[lvl]) >= self.k:
                    self._compact()
                    changed = True
                    break
        return self

    # -- queries -----------------------------------------------------------

    def _weighted(self) -> List[Tuple[float, int]]:
        items: List[Tuple[float, int]] = []
        for lvl, buf in enumerate(self._levels):
            w = 1 << lvl
            items.extend((v, w) for v in buf)
        items.sort(key=lambda t: t[0])
        return items

    def quantile(self, q: float) -> float:
        """Approximate q-quantile, q in [0, 1]."""
        if self.count == 0:
            raise ValueError("empty sketch")
        if q <= 0.0:
            return self._min
        if q >= 1.0:
            return self._max
        items = self._weighted()
        total = sum(w for _, w in items)
        target = q * total
        acc = 0
        for v, w in items:
            acc += w
            if acc >= target:
                return v
        return items[-1][0]

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict:
        return {"k": self.k, "count": self.count,
                "min": self._min, "max": self._max,
                "levels": [list(b) for b in self._levels],
                "coins": list(self._coins)}

    @classmethod
    def from_dict(cls, d: Dict) -> "QuantileSketch":
        s = cls(k=d["k"])
        s.count = int(d["count"])
        s._min = float(d["min"])
        s._max = float(d["max"])
        s._levels = [list(map(float, b)) for b in d["levels"]]
        s._coins = [bool(c) for c in d["coins"]]
        return s
