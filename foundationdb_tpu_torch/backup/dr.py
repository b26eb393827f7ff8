"""Continuous DR: cluster-to-cluster asynchronous replication + switchover.

Port of ``foundationdb_tpu/backup/dr.py``.

Re-design of fdbclient/DatabaseBackupAgent.actor.cpp (:2348) reduced to its
load-bearing shape on this framework's primitives:

  * start(): activate a mutation-log tag on the SOURCE (the same proxy
    circuit the file backup uses: every committed user mutation is copied
    into the tag), then take a chunked range snapshot of the source and
    write it STRAIGHT INTO the destination cluster, recording each chunk's
    read version (the reference's range-file versions);
  * a tailing actor peeks the tag, clips each mutation per destination
    range to versions AFTER that range's chunk version (exactly-once for
    atomic ops, same rule as restore), applies it to the destination in
    transactions, pops the tag, and advances `applied_version` — the
    destination continuously trails the source by the replication lag;
  * switchover(): lockDatabase on the source (proxies reject user commits
    with database_locked from the fence version on; lock-aware management
    transactions pass), drain the tag THROUGH the fence, stop tailing,
    and unlock the destination's role as the new primary. Every commit
    the source ever acknowledged is on the destination when it returns.

The lock fence is exact: a user commit sharing the lock transaction's
batch lands at the fence version and is still tagged + drained; anything
later is rejected at the proxy, so nothing acknowledged is lost.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..client.database import Database
from ..core import error, wire
from ..core.types import Mutation, MutationType, SINGLE_KEY_MUTATIONS
from ..server import system_keys
from ..server.log_system import LogSystemClient
from ..sim.loop import TaskPriority, delay, spawn

USER_END = b"\xff"
APPLY_BATCH = 200


async def lock_database(db: Database) -> int:
    """reference: lockDatabase (ManagementAPI.actor.cpp). Returns the lock
    commit version — the write fence: every user commit at a higher
    version is rejected with database_locked."""
    async def go(tr):
        tr.set_access_system_keys()
        tr.set(system_keys.DB_LOCK_KEY, b"locked")
    await db.run(go)
    tr = db.create_transaction()
    return await tr.get_read_version()


async def unlock_database(db: Database) -> None:
    async def go(tr):
        tr.set_access_system_keys()
        tr.set(system_keys.DB_LOCK_KEY, b"")
    await db.run(go)


class DRAgent:
    """One replication relationship: src -> dest."""

    def __init__(self, sim, src: Database, dest: Database):
        self.sim = sim
        self.src = src
        self.dest = dest
        self.tag: Optional[int] = None
        self.start_version: Optional[int] = None
        #: [(begin, end, chunk_version)] of the initial range sync
        self.ranges: List[Tuple[bytes, bytes, int]] = []
        #: destination reflects every source mutation <= this version
        self.applied_version: int = 0
        self._tailer = None
        self._stopped = False

    # -- source log access ----------------------------------------------------
    async def _log_client(self) -> LogSystemClient:
        from ..server.cluster_controller import CC_OPEN_DATABASE_TOKEN, OpenDatabaseRequest
        from ..server.leader_election import tally_leader_once
        from ..sim.network import Endpoint

        while True:
            leader = await tally_leader_once(self.src.net, self.src.client_addr,
                                             self.src.coordinator_addrs)
            if leader is not None:
                try:
                    info = await self.src.net.request(
                        self.src.client_addr,
                        Endpoint(leader.address, CC_OPEN_DATABASE_TOKEN),
                        OpenDatabaseRequest(), TaskPriority.DEFAULT_ENDPOINT,
                        timeout=1.0)
                except error.FDBError:
                    info = None
                if info is not None and info.log_config is not None:
                    return LogSystemClient(self.src.net, self.src.client_addr,
                                           info.log_config)
            await delay(0.5)

    # -- start: tag + initial sync + tail -------------------------------------
    async def start(self, chunks: int = 8) -> None:
        from .agent import claim_backup_tag

        self.tag = await self.src.run(claim_backup_tag)
        tr = self.src.create_transaction()
        self.start_version = await tr.get_read_version()
        # the destination is a replica while DR runs: lock it so stray
        # writers cannot diverge it (the reference locks the DR dest; the
        # agent's own applies are lock-aware), and CLEAR it — pre-existing
        # destination keys absent from the source would otherwise survive
        # replication and surface on the promoted primary
        await lock_database(self.dest)

        async def wipe(tr2):
            tr2.set_lock_aware()
            tr2.clear_range(b"", USER_END)
        await self.dest.run(wipe)

        # initial range sync, chunked; each chunk at its own fresh version
        bounds = [b""] + [bytes([(256 * i) // chunks])
                          for i in range(1, chunks)] + [USER_END]
        for i in range(chunks):
            while True:
                vtr = self.src.create_transaction()
                vc = await vtr.get_read_version()
                try:
                    rows = await self._read_chunk(bounds[i], bounds[i + 1], vc)
                    break
                except error.FDBError as e:
                    if e.code != error.transaction_too_old("").code:
                        raise
            for j in range(0, len(rows), APPLY_BATCH):
                batch = rows[j:j + APPLY_BATCH]

                async def put(tr2):
                    tr2.set_lock_aware()
                    for k, v in batch:
                        tr2.set(k, v)
                await self.dest.run(put)
            self.ranges.append((bounds[i], bounds[i + 1], vc))
        self.ranges.sort()
        self.applied_version = min(v for (_b, _e, v) in self.ranges)

        self._tailer = spawn(self._tail(), TaskPriority.DEFAULT_ENDPOINT,
                             name="drTail")

    async def _read_chunk(self, begin: bytes, end: bytes, version: int):
        rows: List[Tuple[bytes, bytes]] = []
        tr = self.src.create_transaction()
        tr.read_version = version
        at = begin
        while at < end:
            page = await tr.get_range(at, end, limit=1000, snapshot=True)
            rows.extend(page)
            if len(page) < 1000:
                break
            at = page[-1][0] + b"\x00"
        return rows

    # -- the tail -------------------------------------------------------------
    def _clip(self, m: Mutation) -> List[Tuple[int, Mutation]]:
        """(chunk_version, clipped mutation) parts per destination range —
        a mutation already inside a chunk's snapshot never re-applies
        (exactly-once for atomic ops, the restore rule)."""
        out = []
        if m.type == MutationType.CLEAR_RANGE:
            for b, e, vc in self.ranges:
                cb, ce = max(m.param1, b), min(m.param2, e)
                if cb < ce:
                    out.append((vc, Mutation(m.type, cb, ce)))
        else:
            for b, e, vc in self.ranges:
                if b <= m.param1 < e:
                    out.append((vc, m))
                    break
        return out

    async def _apply(self, entries) -> None:
        todo: List[Mutation] = []
        for v, muts in entries:
            for m in muts:
                todo.extend(cm for (vc, cm) in self._clip(m) if v > vc)
        for i in range(0, len(todo), APPLY_BATCH):
            batch = todo[i:i + APPLY_BATCH]

            async def go(tr):
                tr.set_lock_aware()
                for m in batch:
                    if m.type == MutationType.SET_VALUE:
                        tr.set(m.param1, m.param2)
                    elif m.type == MutationType.CLEAR_RANGE:
                        tr.clear_range(m.param1, m.param2)
                    elif m.type in SINGLE_KEY_MUTATIONS:
                        tr.atomic_op(m.param1, m.param2, m.type)
            await self.dest.run(go)

    async def _tail(self) -> None:
        floor = self.start_version
        client = None
        while not self._stopped:
            if client is None:   # re-resolve only after a peek error
                client = await self._log_client()
            try:
                reply = await client.peek(self.tag, floor + 1, timeout=2.0)
            except error.FDBError:
                client = None    # generation turnover / dead replica
                await delay(0.5)
                continue
            if reply.messages:
                await self._apply(reply.messages)
                client.pop(self.tag, reply.messages[-1][0])
            if reply.end_version > floor:
                floor = reply.end_version
                self.applied_version = max(self.applied_version, floor)
            else:
                await delay(0.25)

    async def wait_for(self, version: int, timeout: float = 60.0) -> None:
        """Block until the destination reflects source version `version`
        (the replication-lag bound)."""
        from ..sim.loop import now

        deadline = now() + timeout
        while self.applied_version < version:
            if now() > deadline:
                raise error.timed_out(
                    f"DR lag: applied {self.applied_version} < {version}")
            await delay(0.2)

    # -- switchover -----------------------------------------------------------
    async def switchover(self) -> int:
        """Fence the source, drain everything acknowledged, promote the
        destination. Returns the fence version. reference:
        DatabaseBackupAgent switchover (atomic via lockDatabase)."""
        fence = await lock_database(self.src)
        await self.wait_for(fence)
        self._stopped = True
        if self._tailer is not None:
            self._tailer.cancel()

        # retire the tag on the source (nothing pins the tlog queues) and
        # clear the active flag — only if it still holds OUR tag (never
        # stomp a backup/DR started after this one ended)
        async def stop(tr):
            tr.set_access_system_keys()
            active = await tr.get(system_keys.BACKUP_ACTIVE_KEY)
            if active and system_keys.decode_backup_active(active) == self.tag:
                tr.set(system_keys.BACKUP_ACTIVE_KEY, b"")
        await self.src.run(stop)
        client = await self._log_client()
        client.pop(self.tag, -1)
        # promote the destination: it serves user traffic now
        await unlock_database(self.dest)
        return fence
