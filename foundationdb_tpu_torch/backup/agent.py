"""Backup/restore agent v0 (reference: fdbclient/FileBackupAgent.actor.cpp
+ design/backup.md, reduced to its load-bearing shape):

  * start_backup(): a transaction sets `\\xff/backup/active` = a fresh log
    tag; from its commit version on, every proxy copies every committed
    user mutation into that tag (the metadata-drain circuit guarantees the
    hand-over version is exact). A log-mover actor peeks the tag, writes
    `log/<first-version>` objects (split under the container object cap;
    restore dedupes by version) and pops as it goes.
  * snapshot(): TaskBucket tasks, one per key chunk, executed by N agent
    workers — each chunk reads at its own fresh version and writes a
    version-prefixed PART SET `range/<id>/<version>-<part>` capped per
    object, sealed by a `range/<id>/<version>-done` marker (the
    reference's versioned range files); restore selects only the newest
    complete set per chunk, so a re-executed expired claim can never mix
    two executions' parts. Exactly-once chunk execution comes from the
    task bucket's transactional claims.
  * finish_backup(): picks the end version, waits for the log mover to
    pass it, writes the manifest, clears the active flag and retires the
    tag. Restorable = snapshot done AND logs cover every chunk version
    through end_version (tagging started before any chunk read).
  * restore(): loads every range object, then replays log mutations in
    version order clipped per range to versions AFTER that range's chunk
    version — atomic ops replay as atomic ops exactly once, so the
    restored state equals the source state at end_version exactly.

Port of ``foundationdb_tpu/backup/agent.py``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ..bindings.fdb_api import Subspace
from ..bindings.task_bucket import TaskBucket
from ..core import buggify, error, wire
from ..core.types import Mutation, MutationType, SINGLE_KEY_MUTATIONS
from ..client.database import Database
from ..server import system_keys
from ..server.log_system import LogSystemClient
from ..sim.actors import all_of_cancelling
from ..sim.loop import TaskPriority, current_scheduler, delay, spawn
from ..sim.network import Endpoint
from . import container as blob

USER_END = b"\xff"
# objects never exceed this (half the blobstore's 64MB MAX_BODY): an
# unsplit peek reply or snapshot chunk above the container's cap would
# draw a 413 — non-retryable — and permanently kill the backup
CONTAINER_OBJECT_BYTES = 32 << 20
# 60s of a container that answers nothing: the mover escalates from
# transient-retry to a recorded permanent failure so finish_backup fails
# loudly instead of wedging on a dead blobstore. A wall-clock deadline,
# not an attempt count — a black-holing host makes each attempt cost up
# to two io_timeouts, so counting attempts would stretch "a minute" into
# over an hour
MOVER_FAILURE_ESCALATION_SECONDS = 60.0


async def claim_backup_tag(tr) -> int:
    """Claim the (v0 single-slot) mutation-log tag inside `tr`: refuses to
    stomp a running backup/DR, allocates the next tag, sets the active
    flag. Shared by the file backup and DR agents — their claim protocols
    must never diverge."""
    tr.set_access_system_keys()
    active = await tr.get(system_keys.BACKUP_ACTIVE_KEY)
    if active and system_keys.decode_backup_active(active) is not None:
        raise error.client_invalid_operation(
            "a backup/DR already owns the mutation-log tag")
    seq = int(await tr.get(system_keys.BACKUP_SEQ_KEY) or b"0")
    tag = system_keys.FIRST_BACKUP_TAG - seq
    tr.set(system_keys.BACKUP_SEQ_KEY, str(seq + 1).encode())
    tr.set(system_keys.BACKUP_ACTIVE_KEY, system_keys.encode_backup_active(tag))
    return tag


def _approx_row_bytes(kv) -> int:
    return len(kv[0]) + len(kv[1]) + 32


def _approx_message_bytes(msg) -> int:
    _v, muts = msg
    return 16 + sum(len(m.param1) + len(m.param2) + 16 for m in muts)


def _byte_chunks(items: list, size_of, cap: Optional[int] = None) -> List[list]:
    """Greedy split so each group stays under `cap`, sized by a cheap
    per-item ESTIMATE (encoding every item twice just to measure it would
    double serialization CPU on the backup hot path; the cap carries 32MB
    of slack against the container's MAX_BODY, so loose is fine). A lone
    item above cap still gets its own group. The cap resolves at call
    time so the module knob stays patchable."""
    if cap is None:
        cap = CONTAINER_OBJECT_BYTES
    groups: List[list] = []
    cur: list = []
    cur_bytes = 0
    for it in items:
        sz = size_of(it)
        if cur and cur_bytes + sz > cap:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(it)
        cur_bytes += sz
    if cur:
        groups.append(cur)
    return groups


class _ContainerRetry:
    """Transient-failure escalation shared by the log mover and the
    snapshot workers: retryable container errors retry on a 0.5s cadence
    and ESCALATE to permanent only when nothing has succeeded for
    MOVER_FAILURE_ESCALATION_SECONDS — any completed put resets the
    window, because partial progress means the container is answering
    (a flaky-but-alive store must not be declared dead)."""

    def __init__(self):
        self._first_fail: Optional[float] = None

    def succeeded(self) -> None:
        self._first_fail = None

    async def failed(self, e: "error.FDBError") -> None:
        """Re-raise if permanent or escalated; otherwise sleep the retry.
        The clock can't be interleaved by other failure domains: callers
        retry the failed put IN PLACE, so a failure streak never leaves
        the put loop except by success (reset) or by raising here."""
        if not e.is_retryable():
            raise e
        now = current_scheduler().time
        if self._first_fail is None:
            self._first_fail = now
        elif now - self._first_fail >= MOVER_FAILURE_ESCALATION_SECONDS:
            raise e
        await delay(0.5)


BLOBSTORE_SCHEME = "blobstore://"


class _RPCContainer:
    """Container IO against a process hosting BlobContainer endpoints
    (sim and real transport alike)."""

    def __init__(self, db: Database, addr: str):
        self.db = db
        self.addr = addr

    async def put(self, name: str, data: bytes) -> None:
        await self.db.net.request(
            self.db.client_addr, Endpoint(self.addr, blob.PUT_TOKEN),
            blob.BlobPut(name, data), TaskPriority.DEFAULT_ENDPOINT, timeout=5.0)

    async def get(self, name: str) -> Optional[bytes]:
        return await self.db.net.request(
            self.db.client_addr, Endpoint(self.addr, blob.GET_TOKEN),
            blob.BlobGet(name), TaskPriority.DEFAULT_ENDPOINT, timeout=5.0)

    async def list(self, prefix: str) -> List[str]:
        return await self.db.net.request(
            self.db.client_addr, Endpoint(self.addr, blob.LIST_TOKEN),
            blob.BlobList(prefix), TaskPriority.DEFAULT_ENDPOINT, timeout=5.0)

    def close(self) -> None:
        return None   # the RPC path holds no connection state


class _HTTPContainer:
    """Container IO against a blobstore://host:port HTTPBlobServer
    (backup/http_blob.py), reached over asyncio — only meaningful under
    the RealScheduler, whose run loop lives inside an asyncio event
    loop. Deadlines live INSIDE HTTPBlobClient (per attempt, after its
    connection lock) — a wrapper timeout here would count queue wait
    behind other transfers against each request's wire-time budget."""

    def __init__(self, address: str):
        # construction is the lazy-import point: this class only exists
        # for blobstore:// targets, so the sim path never pays for (or
        # needs) the real runtime / HTTP modules
        from .http_blob import MAX_BODY, HTTPBlobClient, io_timeout
        from ..real.runtime import aio_to_sim
        from ..real.tls import client_context

        # the blob path inherits the process TLS policy: mutual auth via
        # the shared CA (the subject DSL stays on the RPC transport)
        self.client = HTTPBlobClient(address, ssl_context=client_context())
        self._tasks: set = set()
        self._aio_to_sim = aio_to_sim
        self._io_timeout = io_timeout
        self._max_body = MAX_BODY

    def _aio(self, coro):
        """Bridge into a scheduler Future."""
        return self._aio_to_sim(self._classify(coro), self._tasks)

    async def _classify(self, coro):
        """Map blob HTTP statuses onto FDBError vocabulary BEFORE the
        bridge collapses everything else into retryable connection_failed:
        a 4xx (oversized body, bad request) can never succeed on retry —
        the mover must die loudly, not re-send the same body forever. A
        5xx is the server's own transient trouble (momentary ENOSPC, an
        fsync hiccup answered as 500) and stays retryable, same as a
        dropped connection at the same moment would be."""
        from .http_blob import BlobClientShutdown, BlobHTTPError
        try:
            return await coro
        except BlobClientShutdown as e:
            # a shut-down client is PERMANENT — retrying would spin a
            # still-running mover forever against a dead connection
            raise error.client_invalid_operation(str(e)) from e
        except BlobHTTPError as e:
            if 400 <= e.status < 500:
                raise error.client_invalid_operation(str(e)) from e
            raise error.connection_failed(str(e)) from e

    async def put(self, name: str, data: bytes) -> None:
        # the deadline scales with body size — a near-MAX_BODY chunk
        # can't clear a flat 5s cap, and cancel-reconnect-resend on a
        # legitimately slow large PUT would loop forever
        await self._aio(self.client.put(
            name, data, timeout=self._io_timeout(len(data))))

    async def get(self, name: str) -> Optional[bytes]:
        # response size is unknown up front: budget for the largest
        # object the server can hold — a restore must be able to read
        # back anything a scaled-deadline put managed to write
        return await self._aio(self.client.get(
            name, timeout=self._io_timeout(self._max_body)))

    async def list(self, prefix: str) -> List[str]:
        return await self._aio(self.client.list(
            prefix, timeout=self._io_timeout(self._max_body)))

    def close(self) -> None:
        # shutdown (not close): an in-flight retry must not resurrect
        # the connection after teardown
        self.client.shutdown()


class BackupAgent:
    def __init__(self, sim, db: Database, container_addr: str):
        self.sim = sim
        self.db = db
        self.tag: Optional[int] = None
        self.start_version: Optional[int] = None
        self.snapshot_version: Optional[int] = None
        self.end_version: Optional[int] = None
        self._log_floor: Optional[int] = None
        self._mover = None
        self._mover_error: Optional[BaseException] = None
        self._snapshot_chunks: Optional[int] = None
        if container_addr.startswith(BLOBSTORE_SCHEME):
            self._container = _HTTPContainer(
                container_addr[len(BLOBSTORE_SCHEME):])
        else:
            self._container = _RPCContainer(db, container_addr)

    # -- container io --------------------------------------------------------
    def close(self) -> None:
        """Release container resources (blobstore:// targets keep a
        persistent connection)."""
        self._container.close()

    async def _put(self, name: str, data: bytes) -> None:
        await self._container.put(name, data)

    async def _put_retrying(self, name: str, data: bytes,
                            retry: _ContainerRetry) -> None:
        """Put with in-place transient retry under `retry`'s escalation
        window (re-puts are idempotent everywhere this is used); raises
        on permanent or escalated failure."""
        while True:
            try:
                await self._put(name, data)
            except error.FDBError as e:
                await retry.failed(e)
                continue
            retry.succeeded()
            return

    async def _get(self, name: str) -> Optional[bytes]:
        return await self._container.get(name)

    async def _list(self, prefix: str) -> List[str]:
        return await self._container.list(prefix)

    # -- log access ----------------------------------------------------------
    async def _log_client(self) -> LogSystemClient:
        """The current generation's log config, fetched like any client
        learns the cluster: from the CC's ServerDBInfo."""
        from ..server.cluster_controller import CC_OPEN_DATABASE_TOKEN, OpenDatabaseRequest
        from ..server.leader_election import tally_leader_once

        while True:
            leader = await tally_leader_once(self.db.net, self.db.client_addr,
                                             self.db.coordinator_addrs)
            if leader is not None:
                try:
                    info = await self.db.net.request(
                        self.db.client_addr,
                        Endpoint(leader.address, CC_OPEN_DATABASE_TOKEN),
                        OpenDatabaseRequest(), TaskPriority.DEFAULT_ENDPOINT,
                        timeout=1.0)
                except error.FDBError:
                    info = None
                if info is not None and info.log_config is not None:
                    return LogSystemClient(self.db.net, self.db.client_addr,
                                           info.log_config)
            await delay(0.5)

    # -- backup --------------------------------------------------------------
    async def start_backup(self) -> None:
        self.tag = await self.db.run(claim_backup_tag)
        tr = self.db.create_transaction()
        self.start_version = await tr.get_read_version()
        self._log_floor = self.start_version
        self._mover_error: Optional[BaseException] = None
        self._mover = spawn(self._log_mover(), TaskPriority.DEFAULT_ENDPOINT,
                            name="backupLogMover")

    async def _log_mover(self) -> None:
        """Continuously drain the backup tag into log/<version> objects.
        A permanent failure is RECORDED, not just raised — a spawned
        task's exception is unobserved, and finish_backup's wait on
        _log_floor would otherwise wedge silently."""
        try:
            await self._log_mover_loop()
        except Exception as e:  # noqa: BLE001 — ANY unobserved death wedges
            # finish_backup; OperationCancelled (BaseException) still
            # propagates so mover.cancel() stays silent
            self._mover_error = e

    async def _log_mover_loop(self) -> None:
        floor = self._log_floor
        retry = _ContainerRetry()
        while True:
            client = await self._log_client()
            try:
                reply = await client.peek(self.tag, floor + 1, timeout=2.0)
            except error.FDBError:
                # log-side failure: retry the peek (the container
                # escalation clock is necessarily idle here — put
                # failures retry in place and never fall back to peek)
                await delay(0.5)
                continue
            if reply.messages:
                if buggify.buggify():
                    # mover stall mid-drain: the backup tag backs up at the
                    # tlogs (spill pressure) and restorability lags
                    await delay(1.0)
                # split below the container's object cap; each group is
                # named by its first version, so a crash-shaped re-peek
                # re-puts the same (or superset) objects — restore
                # dedupes by version either way. A transient failure
                # resumes at the failed GROUP (earlier puts are durable;
                # re-uploading them would multiply bandwidth per blip);
                # permanent/escalated errors re-raise out of retry
                # (recorded by the wrapper, surfaced by finish_backup).
                for group in _byte_chunks(list(reply.messages),
                                          _approx_message_bytes):
                    await self._put_retrying("log/%020d" % group[0][0],
                                             wire.dumps(group), retry)
                if buggify.buggify():
                    # crash-shaped duplicate: object written but pop lost —
                    # the next peek re-serves; restore must dedupe by version
                    continue
                client.pop(self.tag, reply.messages[-1][0])
            if reply.end_version > floor:
                floor = reply.end_version
                self._log_floor = floor
            else:
                await delay(0.25)

    async def snapshot(self, chunks: int = 8, workers: int = 3) -> None:
        """Range snapshot via TaskBucket chunk tasks. Each chunk reads at
        its OWN fresh version (the reference's range files each carry a
        version, design/backup.md): a chunk needs only its own reads to
        fit the MVCC window, however slow task claiming is. restore()
        replays log mutations per range from that range's chunk version,
        which keeps atomic ops exactly-once."""
        bucket = TaskBucket(Subspace((b"backup-tasks",)), timeout_seconds=20.0)
        bounds = [b""] + [bytes([(256 * i) // chunks]) for i in range(1, chunks)] + [USER_END]

        async def add_tasks(tr2):
            lo, hi = bucket.avail.range()
            tr2.clear_range(lo, hi)
            lo, hi = bucket.timeouts.range()
            tr2.clear_range(lo, hi)
            for i in range(chunks):
                bucket.add(tr2, i, {b"begin": bounds[i], b"end": bounds[i + 1]})
        await self.db.run(add_tasks)
        versions: List[int] = []

        async def worker(wid: int):
            while True:
                tr2 = self.db.create_transaction()
                try:
                    task = await bucket.get_one(tr2)
                    if task is None:
                        if await bucket.is_empty(tr2):
                            return
                        # only claimed tasks remain; resurface expired
                        # claims (a maybe-committed claim whose worker
                        # moved on would otherwise strand the task and
                        # busy-wait every worker here forever)
                        await bucket.check_timeouts(tr2)
                        await tr2.commit()
                        await delay(0.5)
                        continue
                    await tr2.commit()
                except error.FDBError as e:
                    if e.is_retryable() or e.is_maybe_committed():
                        continue
                    raise
                while True:
                    if buggify.buggify():
                        # slow chunk worker: its claim may expire and another
                        # worker re-executes — exactly-once must still hold
                        await delay(1.0)
                    vtr = self.db.create_transaction()
                    vc = await vtr.get_read_version()
                    try:
                        rows = await self._read_chunk(task.params[b"begin"],
                                                      task.params[b"end"], vc)
                        break
                    except error.FDBError as e:
                        if e.code != error.transaction_too_old("").code:
                            raise
                        # chunk outlived the window: fresh version, re-read
                # a VERSION-PREFIXED part set per execution: parts stay
                # under the container's object cap, and a re-executed
                # chunk (expired claim) writes a disjoint fresh set — no
                # mixing of two executions' parts. The "-done" marker
                # makes a set visible to restore only once complete;
                # stale/partial sets are simply never selected. Transient
                # container loss retries (re-puts are idempotent: same
                # names, same rows) under the same escalation window the
                # log mover gets — one blip must not kill the backup.
                parts = _byte_chunks(rows, _approx_row_bytes) or [[]]
                retry = _ContainerRetry()
                pb = task.params[b"begin"]
                for j, part in enumerate(parts):
                    pe = (parts[j + 1][0][0] if j + 1 < len(parts)
                          else task.params[b"end"])
                    await self._put_retrying(
                        "range/%04d/%012d-%03d" % (task.id, vc, j),
                        wire.dumps({"begin": pb, "end": pe,
                                    "version": vc, "rows": part}),
                        retry)
                    pb = pe
                await self._put_retrying(
                    "range/%04d/%012d-done" % (task.id, vc),
                    wire.dumps(len(parts)), retry)
                versions.append(vc)

                async def done(tr3):
                    bucket.finish(tr3, task)
                await self.db.run(done)

        try:
            await all_of_cancelling([
                spawn(worker(w), TaskPriority.DEFAULT_ENDPOINT,
                      name=f"backupSnap{w}")
                for w in range(workers)
            ])
        except Exception:   # noqa: BLE001 — ANY worker death, not just
            # FDBError (a serialization TypeError pins the tag the same
            # way): a dead snapshot is a dead backup — release the tag
            # claim (and stop the mover) rather than wedge the slot
            await self.abort_backup()
            raise
        self._snapshot_chunks = chunks
        self.snapshot_version = min(versions) if versions else self.start_version

    async def _read_chunk(self, begin: bytes, end: bytes, version: int):
        rows: List[Tuple[bytes, bytes]] = []
        tr = self.db.create_transaction()
        tr.read_version = version
        at = begin
        while at < end:
            page = await tr.get_range(at, end, limit=1000, snapshot=True)
            rows.extend(page)
            if len(page) < 1000:
                break
            at = page[-1][0] + b"\x00"
        return rows

    async def finish_backup(self) -> None:
        """Pick the end version, wait for log coverage, write the manifest,
        stop the proxies' copying and retire the tag."""
        tr = self.db.create_transaction()
        self.end_version = await tr.get_read_version()
        while self._log_floor < self.end_version:
            if self._mover_error is not None:
                # release the tag claim before surfacing — a failed
                # backup must not pin the mutation-log slot (and the
                # tlogs' spill) forever
                await self.abort_backup()
                raise self._mover_error
            await delay(0.25)

        async def stop(tr2):
            tr2.set_access_system_keys()
            tr2.set(system_keys.BACKUP_ACTIVE_KEY, b"")
        await self.db.run(stop)

        # same transient-retry window as every other container write: a
        # single blip at manifest time must not tear down a completed
        # backup. Escalated/permanent failure aborts — without the
        # manifest the backup is unrestorable anyway, so don't leave the
        # mover alive and the tag pinned on top.
        try:
            await self._put_retrying("manifest", wire.dumps({
                "snapshot_version": self.snapshot_version,
                "end_version": self.end_version,
                "start_version": self.start_version,
                "chunks": self._snapshot_chunks,
            }), _ContainerRetry())
        except Exception:   # noqa: BLE001 — escalated OR foreign: either
            # way the backup is unrestorable without the manifest; don't
            # leave the mover alive and the tag pinned on top
            await self.abort_backup()
            raise
        self._mover.cancel()
        client = await self._log_client()
        client.pop(self.tag, -1)   # retire: nothing pins the queue front

    async def abort_backup(self) -> None:
        """Best-effort teardown after a FAILED backup (reference:
        fdbbackup abort): stop the mover, release the single mutation-log
        slot so a new backup/DR can claim it, and retire the tag so the
        tlogs stop spilling it. Callers hit this via finish_backup's
        mover-error edge, or directly after snapshot() raises."""
        if self._mover is not None:
            self._mover.cancel()

        async def clear(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.BACKUP_ACTIVE_KEY, b"")
        try:
            await self.db.run(clear)
        except error.FDBError:
            pass
        try:
            client = await self._log_client()
            client.pop(self.tag, -1)
        except error.FDBError:
            pass

    # -- restore -------------------------------------------------------------
    async def restore(self, dest: Database) -> int:
        """Restore the backup into `dest` (an empty keyspace). Returns the
        restored end version. Log mutations replay per range from that
        range's chunk version — a mutation already reflected in a chunk's
        snapshot (v <= chunk version) is never applied twice, which is
        what keeps atomic ops exact."""
        raw_manifest = await self._get("manifest")
        if raw_manifest is None:
            raise error.client_invalid_operation(
                "container has no manifest — backup not finished?")
        manifest = wire.loads(raw_manifest)
        vend = manifest["end_version"]

        # pick, per chunk id, the NEWEST complete part set: a re-executed
        # chunk leaves older (or unfinished) version-prefixed sets behind,
        # and loading two executions' parts together would mix snapshot
        # versions within one key range
        def parse_part(name: str):
            """(cid, version) from range/<cid>/<version>-<part|done>, or
            None for anything else — a foreign or legacy-named object in
            the container must be ignored, not crash the restore."""
            cid, sep, vtag = name[len("range/"):].partition("/")
            if not sep:
                return None
            try:
                return cid, int(vtag.split("-")[0])
            except ValueError:
                return None

        names = await self._list("range/")
        newest: Dict[str, int] = {}
        for name in names:
            parsed = parse_part(name)
            if parsed is None or not name.endswith("-done"):
                continue
            cid, vc = parsed
            newest[cid] = max(newest.get(cid, -1), vc)
        n_chunks = manifest.get("chunks")
        if n_chunks is not None:
            # a WHOLE chunk's set (marker included) vanishing would
            # otherwise skip silently — chunk ids are 0..chunks-1
            expected_cids = {"%04d" % i for i in range(n_chunks)}
            if set(newest) != expected_cids:
                raise error.client_invalid_operation(
                    "container chunk sets don't match the manifest: "
                    f"missing {sorted(expected_cids - set(newest))}, "
                    f"unexpected {sorted(set(newest) - expected_cids)}")
        listed = set(names)
        part_names: List[str] = []
        for cid, vc in sorted(newest.items()):
            # the marker's stored part count is the completeness check: a
            # lost/omitted part object must fail the restore loudly, not
            # silently drop its key subrange from snapshot AND log replay
            n_parts = wire.loads(await self._get(
                "range/%s/%012d-done" % (cid, vc)))
            expect = ["range/%s/%012d-%03d" % (cid, vc, j)
                      for j in range(n_parts)]
            missing = [n for n in expect if n not in listed]
            if missing:
                raise error.client_invalid_operation(
                    f"chunk {cid}: sealed part set at version {vc} is "
                    f"missing {len(missing)} of {n_parts} parts")
            part_names.extend(expect)
        if names and not part_names:
            # range objects exist but none parse to a complete set:
            # restoring "successfully" with zero rows would be
            # data-loss-shaped — refuse loudly instead
            raise error.client_invalid_operation(
                "container holds range objects but no complete part set "
                "was recognized (foreign or corrupt format)")

        ranges: List[Tuple[bytes, bytes, int]] = []
        for name in part_names:
            chunk = wire.loads(await self._get(name))
            ranges.append((chunk["begin"], chunk["end"], chunk["version"]))
            rows = chunk["rows"]
            for i in range(0, len(rows), 200):
                batch = rows[i:i + 200]

                async def put_batch(tr):
                    for k, v in batch:
                        tr.set(k, v)
                await dest.run(put_batch)
        ranges.sort()
        begins = [b for b, _e, _vc in ranges]

        def clip(m: Mutation) -> List[Tuple[int, Mutation]]:
            """(chunk_version, clipped mutation) parts of m per range.
            Bisect over the sorted disjoint ranges — part-splitting put
            the list at ~object-count, and a linear scan per mutation
            would make log replay O(mutations x parts)."""
            out = []
            if m.type == MutationType.CLEAR_RANGE:
                i = max(bisect.bisect_right(begins, m.param1) - 1, 0)
                for b, e, vc in ranges[i:]:
                    if b >= m.param2:
                        break
                    cb, ce = max(m.param1, b), min(m.param2, e)
                    if cb < ce:
                        out.append((vc, Mutation(m.type, cb, ce)))
            else:
                i = bisect.bisect_right(begins, m.param1) - 1
                if i >= 0:
                    b, e, vc = ranges[i]
                    if b <= m.param1 < e:
                        out.append((vc, m))
            return out

        seen_versions: set = set()
        for name in await self._list("log/"):
            entries = wire.loads(await self._get(name))
            for v, muts in entries:
                if v > vend or v in seen_versions:
                    # dedupe: a crash-shaped re-put after a shifted group
                    # split can repeat a version across log objects, and
                    # replaying it twice would double-apply atomic ops
                    continue
                seen_versions.add(v)
                todo = [cm for m in muts for (vc, cm) in clip(m) if v > vc]
                for i in range(0, len(todo), 200):
                    batch = todo[i:i + 200]

                    async def apply_batch(tr):
                        for m in batch:
                            if m.type == MutationType.SET_VALUE:
                                tr.set(m.param1, m.param2)
                            elif m.type == MutationType.CLEAR_RANGE:
                                tr.clear_range(m.param1, m.param2)
                            elif m.type in SINGLE_KEY_MUTATIONS:
                                tr.atomic_op(m.param1, m.param2, m.type)
                    await dest.run(apply_batch)
        return vend
