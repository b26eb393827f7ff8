"""Counters: per-role operational metrics with periodic trace emission.

Port of ``foundationdb_tpu/core/stats.py``; the periodic logger actor
(`run_logger`) waits on the port's simulator clock (`sim.loop.delay`).

Analog of flow/Stats.h (Counter, CounterCollection, traceCounters): roles
register named counters in a collection; a recurring actor emits one
`*Metrics` trace event per interval with the values and rates, and the
status document surfaces the same numbers. Counters are plain ints — the
deterministic sim needs no atomics (SURVEY.md §5 race-detection strategy).
"""
from __future__ import annotations

from typing import Dict

from .trace import TraceEvent


class Counter:
    __slots__ = ("name", "value", "_last_value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._last_value = 0

    def add(self, n: int = 1) -> None:
        self.value += n

    def rate_since_last(self, dt: float) -> float:
        d = self.value - self._last_value
        self._last_value = self.value
        return d / dt if dt > 0 else 0.0


class CounterCollection:
    """reference: CounterCollection + traceCounters (flow/Stats.h:112).
    With `tdmetrics` attached (a TDMetricCollection), every periodic
    trace also records each counter's level into the time-series registry
    — one hookup instruments every role for the MetricLogger."""

    def __init__(self, role: str, id: object = None, tdmetrics=None):
        self.role = role
        self.id = id
        self.counters: Dict[str, Counter] = {}
        self.tdmetrics = tdmetrics

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def add(self, name: str, n: int = 1) -> None:
        self.counter(name).add(n)

    def as_dict(self) -> Dict[str, int]:
        return {name: c.value for name, c in sorted(self.counters.items())}

    def trace(self, dt: float) -> None:
        ev = TraceEvent(f"{self.role}Metrics", id=self.id)
        for name, c in sorted(self.counters.items()):
            ev.detail(name, c.value)
            ev.detail(f"{name}Rate", round(c.rate_since_last(dt), 2))
            if self.tdmetrics is not None:
                mid = f".{self.id}" if self.id is not None else ""
                self.tdmetrics.int64(f"{self.role}{mid}.{name}").set(c.value)
        ev.log()

    async def run_logger(self, interval: float = 5.0):
        """Periodic traceCounters actor; spawn on the owning process."""
        from ..sim.loop import delay

        while True:
            await delay(interval)
            self.trace(interval)
