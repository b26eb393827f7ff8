"""TaskBucket: a transactional distributed task queue in the keyspace.

Port of ``foundationdb_tpu/bindings/task_bucket.py``.

Re-design of fdbclient/TaskBucket.actor.cpp round-2 scope: tasks are rows
under a subspace; executors CLAIM a task transactionally (move it from the
available space to the timeout space stamped with a reclaim deadline), so
exactly one executor works each task; finishing clears it; a claimer that
dies resurfaces its task after the deadline (check_timeouts). This is the
substrate the reference's backup/restore agents schedule themselves on —
conflict detection provides the exactly-once-claim guarantee for free.

Keys:
  <prefix>/avail/<task id>            -> packed params
  <prefix>/timeout/<deadline>/<id>    -> packed params
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..sim.loop import now
from . import fdb_tuple
from .fdb_api import Subspace


class Task:
    def __init__(self, id: int, params: Dict[str, Any], timeout_key: Optional[bytes] = None):
        self.id = id
        self.params = params
        self.timeout_key = timeout_key


class TaskBucket:
    def __init__(self, subspace: Subspace, timeout_seconds: float = 10.0):
        self.avail = subspace["avail"]
        self.timeouts = subspace["timeout"]
        self.timeout_seconds = timeout_seconds

    # -- producer -------------------------------------------------------------
    def add(self, tr, task_id: int, params: Dict[str, Any]) -> None:
        """reference: TaskBucket::addTask."""
        payload = fdb_tuple.pack(tuple(sorted(params.items())))
        tr.set(self.avail.pack((task_id,)), payload)

    # -- executor -------------------------------------------------------------
    async def get_one(self, tr) -> Optional[Task]:
        """Claim one available task (TaskBucket::getOne): moves it into the
        timeout space under a reclaim deadline. The read of the available
        row is a conflict range, so two racing claimers cannot both win."""
        lo, hi = self.avail.range()
        rows = await tr.get_range(lo, hi, limit=1)
        if not rows:
            return None
        key, payload = rows[0]
        (task_id,) = self.avail.unpack(key)
        deadline = int((now() + self.timeout_seconds) * 1000)
        tkey = self.timeouts.pack((deadline, task_id))
        tr.clear(key)
        tr.set(tkey, payload)
        params = dict(fdb_tuple.unpack(payload))
        return Task(task_id, params, timeout_key=tkey)

    def finish(self, tr, task: Task) -> None:
        """reference: TaskBucket::finish — the claim row disappears."""
        if task.timeout_key is not None:
            tr.clear(task.timeout_key)

    async def check_timeouts(self, tr) -> int:
        """Requeue expired claims (TaskBucket::checkTimeouts); returns how
        many moved back to available."""
        deadline_now = int(now() * 1000)
        lo = self.timeouts.pack(())
        hi = self.timeouts.pack((deadline_now,))
        rows = await tr.get_range(lo, hi)
        for key, payload in rows:
            _deadline, task_id = self.timeouts.unpack(key)
            tr.clear(key)
            tr.set(self.avail.pack((task_id,)), payload)
        return len(rows)

    async def is_empty(self, tr) -> bool:
        for space in (self.avail, self.timeouts):
            lo, hi = space.range()
            if await tr.get_range(lo, hi, limit=1):
                return False
        return True
