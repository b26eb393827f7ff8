"""MetricLogger: persist TDMetrics into the database itself.

Port of ``foundationdb_tpu/client/metric_logger.py``.

Re-design of fdbclient/MetricLogger.actor.cpp: an actor drains a process's
TDMetricCollection on an interval and writes each metric's change blocks
into the `\\xff/metrics/` keyspace, keyed so a time-range read is one
range read:

    \\xff/metrics/<process>/<metric>/<time-be-bytes> = wire([(t, v), ...])

Blocks are transactional writes through the normal commit path (ordered
with user traffic, replicated, recovered); queries reconstruct a level
metric at any time from its change history."""
from __future__ import annotations

import struct
from typing import List, Tuple

from ..core import error, wire
from ..core.tdmetric import TDMetricCollection
from ..sim.loop import delay

METRICS_PREFIX = b"\xff/metrics/"


def _block_key(process: str, metric: str, t: float, seq: int = 0) -> bytes:
    # millisecond-resolution big-endian time + a per-logger sequence:
    # lexicographic == chronological, and two blocks whose first entries
    # share a millisecond can never overwrite each other
    ms = int(t * 1000)
    return (METRICS_PREFIX + process.encode() + b"/" + metric.encode()
            + b"/" + struct.pack(">QI", ms, seq))


async def run_metric_logger(db, collection: TDMetricCollection,
                            process: str, interval: float = 2.0,
                            sync=None) -> None:
    """Drain `collection` into the database forever (spawn as an actor).
    `sync` is an optional pre-drain hook — pass
    `core.telemetry.hub().sync` so the unified registry pulls engine perf /
    batcher / health values into the collection right before each drain."""
    from ..core import buggify

    seq = 0
    while True:
        await delay(interval)
        if buggify.buggify():
            # laggy telemetry drain: metrics recorded meanwhile must buffer
            # (never drop) and land in a later block — the drain-vs-record
            # interleaving the tdmetric tests pin
            await delay(interval * 4)
        if sync is not None:
            sync()
        drained = collection.drain_all()
        if not drained:
            continue
        seq += 1
        try:
            async def put(tr, seq=seq):
                tr.set_access_system_keys()
                for name, entries in drained.items():
                    tr.set(_block_key(process, name, entries[0][0], seq),
                           wire.dumps(entries))
            await db.run(put)
        except error.FDBError:
            # telemetry is best-effort: re-buffer nothing, drop the block
            # (the reference tolerates metric loss the same way)
            continue


async def read_metric(db, process: str, metric: str,
                      t0: float = 0.0, t1: float = 2**40
                      ) -> List[Tuple[float, int]]:
    """Every persisted (time, value) entry of `metric` in [t0, t1].
    Blocks are keyed by their FIRST entry's time, so the scan starts at
    the metric's beginning (a block straddling t0 would otherwise be
    missed) and the per-entry filter clips exactly."""
    lo = _block_key(process, metric, 0.0)
    hi = _block_key(process, metric, t1, 2**32 - 1) + b"\xff"

    async def rd(tr):
        tr.set_access_system_keys()
        return await tr.get_range(lo, hi, limit=10_000, snapshot=True)

    rows = await db.run(rd)
    out: List[Tuple[float, int]] = []
    for _k, v in rows:
        out.extend((t, val) for t, val in wire.loads(v) if t0 <= t <= t1)
    return out
