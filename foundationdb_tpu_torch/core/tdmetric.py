"""TDMetric: time-series metrics with on-cluster persistence.

Port of ``foundationdb_tpu/core/tdmetric.py`` (the MetricLogger that
drains it into the database is not ported yet).

Re-design of flow/TDMetric.actor.h (1373 LoC) reduced to its load-bearing
shape: named metrics record (time, value) CHANGES (not samples — a
time-series of a level metric is its edit history, which reconstructs the
exact value at any time), buffered in bounded in-memory blocks that the
MetricLogger (client/metric_logger.py) periodically drains into the
database's `\\xff/metrics/` keyspace, where they are queryable by
(metric, time range) — the reference's metric-database design
(fdbclient/MetricLogger.actor.cpp).

  * Int64Metric   — a level: set()/increment(); records on change
  * BoolMetric    — a level of 0/1
  * ContinuousMetric — an event stream: log(value) records every event
  * TDMetricCollection — the per-process registry the logger drains
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: per-metric in-memory buffer bound: oldest entries drop first (the
#: reference bounds block memory the same way; persistence is best-effort
#: telemetry, never backpressure)
MAX_BUFFERED = 4096


class _BaseMetric:
    def __init__(self, collection: "TDMetricCollection", name: str):
        self.name = name
        self.collection = collection
        #: undrained (time, value) entries
        self.buffer: List[Tuple[float, int]] = []

    def _record(self, value: int) -> None:
        self.buffer.append((self.collection.now(), value))
        if len(self.buffer) > MAX_BUFFERED:
            del self.buffer[: len(self.buffer) - MAX_BUFFERED]

    def drain(self) -> List[Tuple[float, int]]:
        out, self.buffer = self.buffer, []
        return out


class Int64Metric(_BaseMetric):
    """A level metric: the series is its change history."""

    def __init__(self, collection, name):
        super().__init__(collection, name)
        self.value = 0

    def set(self, v: int) -> None:
        if v != self.value:
            self.value = v
            self._record(v)

    def increment(self, by: int = 1) -> None:
        self.value += by
        self._record(self.value)


class BoolMetric(Int64Metric):
    def set(self, v) -> None:  # type: ignore[override]
        super().set(1 if v else 0)


class ContinuousMetric(_BaseMetric):
    """An event metric: every log() is an entry."""

    def log(self, value: int = 1) -> None:
        self._record(value)


class TDMetricCollection:
    """Per-process metric registry (TDMetricCollection's role). `now` is
    injected (the sim's virtual clock or the wall clock)."""

    def __init__(self, now=None):
        import time as _time

        self.now = now or _time.monotonic  # wall-mode default; a simulator passes its virtual clock as `now`
        self.metrics: Dict[str, _BaseMetric] = {}

    def int64(self, name: str) -> Int64Metric:
        m = self.metrics.get(name)
        if m is None:
            m = self.metrics[name] = Int64Metric(self, name)
        assert isinstance(m, Int64Metric)
        return m

    def bool(self, name: str) -> BoolMetric:
        m = self.metrics.get(name)
        if m is None:
            m = self.metrics[name] = BoolMetric(self, name)
        assert isinstance(m, BoolMetric)
        return m

    def continuous(self, name: str) -> ContinuousMetric:
        m = self.metrics.get(name)
        if m is None:
            m = self.metrics[name] = ContinuousMetric(self, name)
        assert isinstance(m, ContinuousMetric)
        return m

    def drain_all(self) -> Dict[str, List[Tuple[float, int]]]:
        """Undrained entries of every metric (cleared)."""
        out = {}
        for name, m in self.metrics.items():
            entries = m.drain()
            if entries:
                out[name] = entries
        return out

    def value_at(self, name: str, t: float,
                 persisted: List[Tuple[float, int]]) -> Optional[int]:
        """Reconstruct a level metric's value at time t from its persisted
        change history (the TDMetric read model)."""
        best = None
        for et, v in persisted:
            if et <= t:
                best = v
        return best
