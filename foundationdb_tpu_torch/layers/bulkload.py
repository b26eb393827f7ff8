"""Bulk loader: parallel chunked imports through ordinary transactions.

Port of ``foundationdb_tpu/layers/bulkload.py``.

Re-design of layers/bulkload/bulk.py: split a row stream into bounded
batches and commit them with N concurrent worker actors, each batch one
transaction (so a retried batch is idempotent — blind sets). Rows in one
batch share a commit version; batches land independently, which is the
point: aggregate throughput scales with workers until the proxies'
batch pipeline saturates, not with any single txn's latency."""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..sim.actors import all_of_cancelling
from ..sim.loop import spawn


async def bulk_load(db, rows: Iterable[Tuple[bytes, bytes]],
                    batch_size: int = 100, workers: int = 4) -> int:
    """Write every (key, value); returns the row count."""
    batches: List[List[Tuple[bytes, bytes]]] = [[]]
    for kv in rows:
        if len(batches[-1]) >= batch_size:
            batches.append([])
        batches[-1].append(kv)
    if batches == [[]]:
        return 0
    total = sum(len(b) for b in batches)
    cursor = iter(batches)

    async def worker() -> None:
        for batch in cursor:   # shared iterator: workers pull next batch
            async def put(tr, b=batch):
                for k, v in b:
                    tr.set(k, v)
            await db.run(put)

    await all_of_cancelling([spawn(worker(), name=f"bulkload-{i}")
                             for i in range(max(1, workers))])
    return total
