"""TLog: tag-partitioned replicated in-memory durable log, epoch-aware.

Port of ``foundationdb_tpu/server/tlog.py``.

Round-2 scope of fdbserver/TLogServer.actor.cpp: a log generation is K tlog
replicas; the proxy pushes every commit to all of them and acks the client
only when all have fsynced (all-ack = the reference's default quorum with
anti-quorum 0). Each commit carries the proxy's known-committed version
(KCV: the newest version already acked by every replica); peeks serve data
only up to min(durable, KCV), so a storage server can never apply a version
that epoch-end recovery might discard — which is what lets recovery skip
storage rollbacks entirely.

Epoch end (tLogLock:496): a recovering master locks the generation; a
locked tlog rejects further commits (tlog_stopped) and reports
(known_committed, durable end). Locking any single replica freezes the
generation, because all-ack pushes can no longer complete. Commits carry
the generation id; a tlog rejects pushes from any other generation, so an
orphaned previous master's proxies cannot write into a newer generation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.types import Mutation, Version
from ..core import buggify, error, wire
from ..sim.actors import AsyncMutex, NotifiedVersion
from ..sim.loop import Promise, TaskPriority, delay
from ..sim.network import SimProcess
from .disk_queue import DiskQueue
from .messages import (
    TLogCommitRequest,
    TLogKnownCommittedRequest,
    TLogLockReply,
    TLogLockRequest,
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
    TLogRecoveryDataReply,
    TLogRecoveryDataRequest,
)

COMMIT_TOKEN = "tlog.commit"
PEEK_TOKEN = "tlog.peek"
POP_TOKEN = "tlog.pop"
LOCK_TOKEN = "tlog.lock"
KCV_TOKEN = "tlog.knownCommitted"
RECOVERY_DATA_TOKEN = "tlog.recoveryData"
QUEUE_INFO_TOKEN = "tlog.queueInfo"


def _spill_key(tag: int, version: Version) -> bytes:
    """Order-preserving (tag, version) key for the spill store. Tags can be
    negative (METADATA_TAG, backup tags), so bias into unsigned space."""
    return (tag + 2**63).to_bytes(8, "big") + version.to_bytes(8, "big")


class TLog:
    def __init__(
        self,
        proc: SimProcess,
        start_version: Version = 0,
        gen_id: Tuple[int, int] = (0, 0),
        preload: Optional[Dict[int, List[Tuple[Version, List[Mutation]]]]] = None,
        preload_popped: Optional[Dict[int, Version]] = None,
        token_suffix: str = "",
        queue: Optional[DiskQueue] = None,
        store_name: Optional[str] = None,
    ):
        """gen_id = (recovery_count, master_salt): pushes from any other
        generation are rejected. `preload` seeds the tag index with the
        previous generation's un-popped data (the recovery copy), covering
        versions <= start_version. token_suffix distinguishes multiple
        generations hosted by one worker process. With a DiskQueue the tlog
        is durable: commits fsync through it (replacing the simulated-fsync
        delay) and a rebooted worker restores the role from disk
        (restorePersistentState, TLogServer.actor.cpp:1630)."""
        self.proc = proc
        self.gen_id = gen_id
        self.version = NotifiedVersion(start_version)
        self.known_committed = NotifiedVersion(start_version)
        self.stopped = False
        self._stop_promise = Promise()  # fires when the generation is locked
        self.queue = queue
        self._store_name = store_name or f"tlog-{gen_id[0]}.{gen_id[1]}"
        # tag -> ordered [(version, mutations)]
        self.tag_data: Dict[int, List[Tuple[Version, List[Mutation]]]] = dict(preload or {})
        self.popped: Dict[int, Version] = dict(preload_popped or {})
        self.tags_seen = set(self.tag_data) | set(self.popped)
        #: tags whose shard moved away (pop version < 0): straggler pops and
        #: repair re-pushes must not resurrect them, or the queue front pins
        self._retired_tags: set = set()
        #: append-order (version, queue end offset) for front-advance math
        self._ver_offsets: List[Tuple[Version, int]] = []
        #: spill tier (updatePersistentData, TLogServer.actor.cpp:539):
        #: versions <= spilled_version live in a durable KVS, not in
        #: tag_data / the DiskQueue — memory and queue length stay bounded
        #: by the spill threshold however far a slow storage lags
        self.spilled_version: Version = 0
        self._spill_store = None     # lazily-opened SSTableStore
        self._mem_bytes = 0
        self._bytes_by_version: List[Tuple[Version, int]] = []
        self._pops_since_persist = 0
        self._spilling = False
        self._deleted = False    # retired + files dropped; stop persisting
        self._side_mutex = AsyncMutex()   # serializes side-state persists
        self._inflight: set = set()  # versions appended but not yet durable
        self.tokens = {
            "commit": COMMIT_TOKEN + token_suffix,
            "peek": PEEK_TOKEN + token_suffix,
            "pop": POP_TOKEN + token_suffix,
            "lock": LOCK_TOKEN + token_suffix,
            "kcv": KCV_TOKEN + token_suffix,
            "recovery": RECOVERY_DATA_TOKEN + token_suffix,
            "queue_info": QUEUE_INFO_TOKEN + token_suffix,
        }
        proc.register(self.tokens["commit"], self.commit)
        proc.register(self.tokens["peek"], self.peek)
        proc.register(self.tokens["pop"], self.pop)
        proc.register(self.tokens["lock"], self.lock)
        proc.register(self.tokens["kcv"], self.advance_known_committed)
        proc.register(self.tokens["recovery"], self.recovery_data)
        proc.register(self.tokens["queue_info"], self.queue_info)

    def unregister(self) -> None:
        for tok in self.tokens.values():
            self.proc.unregister(tok)

    # -- durability ----------------------------------------------------------
    def _meta_name(self) -> str:
        return self._store_name

    def delete_files(self) -> None:
        """Drop this retired generation's disk footprint."""
        self._deleted = True
        if self.queue is None:
            return
        disk = self.queue.disk
        for suffix in (".meta", ".side", ".side.tmp", ".dq", ".dq.tmp"):
            disk.delete(self._store_name + suffix)
        for name in disk.list(self._store_name + "-spill"):
            disk.delete(name)

    async def persist_initial(self, token_suffix: str) -> None:
        """Write role metadata + the recovery-copy preload durably, so the
        seeded window survives a reboot of this worker."""
        if self.queue is None:
            return
        disk = self.queue.disk
        meta = disk.open(self._meta_name() + ".meta")
        await meta.write(0, wire.dumps({
            "gen_id": self.gen_id,
            "start_version": self.version.get(),
            "token_suffix": token_suffix,
        }))
        await meta.sync()
        # Re-key the preload per version so restore replays it uniformly.
        by_version: Dict[Version, Dict[int, List[Mutation]]] = {}
        for tag, entries in self.tag_data.items():
            for v, muts in entries:
                by_version.setdefault(v, {})[tag] = muts
        for v in sorted(by_version):
            off = await self.queue.push(wire.dumps((v, by_version[v])))
            self._ver_offsets.append((v, off))
        await self.queue.commit()
        await self._persist_side_state(force=True)

    async def _persist_side_state(self, force: bool = False) -> None:
        """Popped map + KCV + the version watermark. Mostly lazily durable
        (stale popped/kcv after a crash only re-serves acknowledged
        entries), but _advance_queue_front forces a sync BEFORE dropping
        queue entries: the watermark is otherwise implied by the newest
        queue entry, and restoring a fully-popped tlog at its start version
        would poison the epoch-end min(end) math with a version below
        already-acknowledged commits."""
        if self.queue is None:
            return
        self._pops_since_persist += 1
        if not force and self._pops_since_persist < 16:
            return
        self._pops_since_persist = 0
        # Fresh file + rename (an in-place rewrite torn by a crash would
        # destroy the version watermark this file exists to protect), under
        # a lock (concurrent pop handlers must not interleave write/rename
        # cycles on the shared tmp file). Snapshot taken inside the lock so
        # an older state can never land after a newer one.
        async with self._side_mutex:
            if self._deleted:
                return   # retired mid-persist: nothing to protect anymore
            disk = self.queue.disk
            payload = wire.dumps({
                "popped": dict(self.popped),
                "kcv": self.known_committed.get(),
                "version": self.version.get(),
                "tags_seen": set(self.tags_seen),
                "retired": set(self._retired_tags),
                "spilled": self.spilled_version,
                # the epoch lock is DURABLE state (reference: the tlog's
                # persistent stopped flag): a locked replica that reboots
                # amnesiac would let a deposed generation's straggler proxy
                # complete an all-ack push of versions the new epoch's
                # recovery already discarded — acked-then-lost commits
                # (found by the sim_validation oracle on DiskAttrition)
                "stopped": self.stopped,
            })
            if self._spill_store is not None:
                await self._spill_store.commit()   # pending pop clears
            tmp = disk.open(self._meta_name() + ".side.tmp")
            await tmp.truncate(0)
            await tmp.write(0, payload)
            await tmp.sync()
            if self._deleted or not disk.exists(self._meta_name() + ".side.tmp"):
                return   # retired between sync and rename (delete_files ran)
            disk.rename(self._meta_name() + ".side.tmp", self._meta_name() + ".side")

    @classmethod
    async def restore(cls, proc: SimProcess, disk, meta_name: str) -> Optional["TLog"]:
        """Rebuild a tlog role from its disk files after a worker reboot."""
        meta_file = disk.open(meta_name)
        raw = await meta_file.read(0, meta_file.size())
        try:
            meta = wire.loads(raw)
        except Exception:
            return None  # torn metadata: role was never fully created
        base = meta_name[: -len(".meta")]
        queue = DiskQueue(disk, base)
        entries = await queue.recover()
        side = {}
        side_file = disk.open(base + ".side")
        raw = await side_file.read(0, side_file.size())
        if raw:
            try:
                side = wire.loads(raw)
            except Exception:
                side = {}
        tlog = cls(
            proc,
            start_version=meta["start_version"],
            gen_id=tuple(meta["gen_id"]),
            token_suffix=meta["token_suffix"],
            queue=queue,
            store_name=base,
        )
        tlog.popped = dict(side.get("popped", {}))
        tlog.tags_seen = set(side.get("tags_seen", set())) | set(tlog.popped)
        tlog._retired_tags = set(side.get("retired", set()))
        tlog.spilled_version = side.get("spilled", 0)
        if side.get("stopped"):
            tlog.stopped = True
            if not tlog._stop_promise.is_set:
                tlog._stop_promise.send(None)
        if (disk.exists(base + "-spill.manifest") or disk.exists(base + "-spill.dq")):
            from .kvstore import SSTableStore

            tlog._spill_store = await SSTableStore.open(disk, base + "-spill")
        version = max(meta["start_version"], side.get("version", 0))
        for off, payload in entries:
            v, messages = wire.loads(payload)
            version = max(version, v)
            tlog._ver_offsets.append((v, off))
            if v <= tlog.spilled_version:
                continue   # already served by the spill store
            kept = False
            for tag, muts in messages.items():
                if tag in tlog._retired_tags:
                    continue
                tlog.tags_seen.add(tag)
                if v > tlog.popped.get(tag, 0):
                    tlog.tag_data.setdefault(tag, []).append((v, muts))
                    kept = True
            if kept:
                # one entry per VERSION, matching the commit path (a
                # per-tag count would overstate memory by the tag
                # multiplicity and trip the spill threshold early)
                tlog._bytes_by_version.append((v, len(payload)))
                tlog._mem_bytes += len(payload)
        tlog.version = NotifiedVersion(version)
        # Restored data is durable here but the KCV horizon must be
        # re-learned; the stored floor keeps already-served data servable.
        tlog.known_committed = NotifiedVersion(
            max(side.get("kcv", 0), meta["start_version"])
        )
        return tlog

    # -- spill tier (updatePersistentData, TLogServer.actor.cpp:539) ---------
    async def _maybe_spill(self) -> None:
        """Move the oldest un-popped versions into the durable spill store
        when the in-memory index outgrows the knob: memory and DiskQueue
        length stay bounded no matter how far a slow storage server lags,
        the reference's btree-spill property."""
        from ..core.knobs import SERVER_KNOBS

        if self.queue is None or self._spilling or self.stopped or self._deleted:
            return
        limit = SERVER_KNOBS.tlog_spill_bytes
        if buggify.buggify():
            limit = 512   # spill eagerly: exercises the tier under load
        if self._mem_bytes <= limit:
            return
        self._spilling = True
        try:
            # Spill the oldest versions until memory halves.
            acc = 0
            target = 0
            for v, nb in self._bytes_by_version:
                if self._mem_bytes - acc <= limit // 2:
                    break
                acc += nb
                target = v
            if target <= self.spilled_version:
                return
            if self._spill_store is None:
                from .kvstore import SSTableStore

                self._spill_store = await SSTableStore.open(
                    self.queue.disk, self._store_name + "-spill")
            st = self._spill_store
            for tag, entries in self.tag_data.items():
                for v, muts in entries:
                    if v <= target:
                        st.set(_spill_key(tag, v), wire.dumps(muts))
            await st.commit()
            self.spilled_version = max(self.spilled_version, target)
            for tag in list(self.tag_data):
                kept = [(v, m) for (v, m) in self.tag_data[tag] if v > target]
                if kept:
                    self.tag_data[tag] = kept
                else:
                    del self.tag_data[tag]
            keep = []
            freed = 0
            for v, nb in self._bytes_by_version:
                if v <= target:
                    freed += nb
                else:
                    keep.append((v, nb))
            self._bytes_by_version = keep
            self._mem_bytes -= freed
            # Watermark (incl. spilled_version) BEFORE truncating the queue:
            # the spill store + side state now carry these versions. A crash
            # between store-commit and side-persist double-stores rows —
            # harmless (idempotent keys); restore dedupes via the watermark.
            await self._persist_side_state(force=True)
            tgt_off = None
            keep_off = []
            for v, off in self._ver_offsets:
                if v <= target:
                    tgt_off = off
                else:
                    keep_off.append((v, off))
            if tgt_off is not None:
                self._ver_offsets = keep_off
                await self.queue.pop_to(tgt_off)
        finally:
            self._spilling = False

    async def _spilled_messages(self, tag: int, begin: Version, end: Version):
        """Spill-store rows for `tag` in [begin, end], ascending, plus a
        truncation flag (the caller must clip end_version when truncated)."""
        if self._spill_store is None or begin > self.spilled_version:
            return [], False
        lo = _spill_key(tag, begin)
        hi = _spill_key(tag, min(end, self.spilled_version) + 1)
        items, more = await self._spill_store.get_range(lo, hi, 5_000)
        out = [(int.from_bytes(k[8:], "big"), wire.loads(v)) for k, v in items]
        return out, more

    async def _advance_queue_front(self) -> None:
        """Discard queue entries whose every tag has popped past them
        (DiskQueue front = min pop location over tags, DiskQueue.actor.cpp
        via tLogPop)."""
        if self.queue is None or not self._ver_offsets:
            return
        floor = min((self.popped.get(t, 0) for t in self.tags_seen), default=0)
        if buggify.buggify():
            # defer front advance once: queue entries linger past their
            # pops, and the next advance must catch up in one jump
            return
        target = None
        keep = []
        for v, off in self._ver_offsets:
            if v <= floor:
                target = off
            else:
                keep.append((v, off))
        if target is not None:
            self._ver_offsets = keep
            # Watermark first: the entries being dropped are the only other
            # durable record of how far this replica's log reached.
            await self._persist_side_state(force=True)
            await self.queue.pop_to(target)

    # -- write path ----------------------------------------------------------
    async def commit(self, req: TLogCommitRequest) -> Version:
        """Append one version; ack after (simulated) fsync. Returns the
        durable version (reference: tLogCommit, TLogServer.actor.cpp:1158)."""
        if req.gen_id != self.gen_id:
            raise error.tlog_stopped(f"generation {req.gen_id} != {self.gen_id}")
        if self.stopped:
            raise error.tlog_stopped("locked by epoch end")
        if req.known_committed > self.known_committed.get():
            self.known_committed.set(min(req.known_committed, self.version.get()))
        if req.version <= self.version.get() or req.version in self._inflight:
            # Duplicate delivery (proxy retry) — possibly while the first
            # copy is mid-fsync; never append twice.
            await self._wait_version_or_stop(req.version)
            return self.version.get()
        await self._wait_version_or_stop(req.prev_version)
        if self.stopped:
            raise error.tlog_stopped("locked by epoch end")
        if req.version <= self.version.get() or req.version in self._inflight:
            await self._wait_version_or_stop(req.version)
            return self.version.get()
        self._inflight.add(req.version)
        for tag, muts in req.messages.items():
            if tag in self._retired_tags:
                continue  # late repair re-push of a moved-away shard's tag
            self.tags_seen.add(tag)
            self.tag_data.setdefault(tag, []).append((req.version, muts))
        if buggify.buggify():
            # Slow disk: stretches the fsync window other failures race with.
            await delay(0.02, TaskPriority.TLOG_COMMIT)
        if self.queue is not None:
            payload = wire.dumps((req.version, req.messages))
            off = await self.queue.push(payload)
            self._ver_offsets.append((req.version, off))
            self._bytes_by_version.append((req.version, len(payload)))
            self._mem_bytes += len(payload)
            await self.queue.commit()
        else:
            from ..core.knobs import SERVER_KNOBS
            await delay(SERVER_KNOBS.tlog_fsync_seconds, TaskPriority.TLOG_COMMIT)
        # Chained waiters run only after this version is durable.
        self._inflight.discard(req.version)
        if self.stopped:
            # Locked mid-fsync: the append is durable locally but must not
            # be acked — the epoch has ended and recovery's end-version math
            # already treats it as maybe-committed.
            raise error.tlog_stopped("locked during fsync")
        self.version.set(req.version)
        # Only the PUSHER's known-committed may raise the KCV. prev_version
        # is NOT safe here with multiple proxies: another proxy's partial
        # push (died before full quorum) can be a later pusher's
        # prev_version, and serving it would diverge from what epoch-end
        # recovery keeps. Fresh KCVs arrive via the proxies' phase-5
        # send_kcv one-ways, which fire only after a push's full quorum ack.
        if req.known_committed > self.known_committed.get():
            self.known_committed.set(min(req.known_committed, self.version.get()))
        from ..core.knobs import SERVER_KNOBS
        if (self.queue is not None and not self._spilling
                and self._mem_bytes > SERVER_KNOBS.tlog_spill_bytes):
            from ..sim.loop import spawn
            task = spawn(self._maybe_spill(), TaskPriority.TLOG_COMMIT,
                         name=f"tlog-spill:{self._store_name}")
            self.proc.actors.add(task)
        return req.version

    async def _wait_version_or_stop(self, version: Version) -> None:
        """when_at_least raced against the epoch lock: a waiter chained
        behind an append that the lock aborted mid-fsync would otherwise
        park forever (the aborted copy never sets the version). The loser's
        callback is detached from the long-lived stop future so the hot
        commit path does not accumulate one closure per commit."""
        if self.version.get() >= version:
            return
        if self.stopped:
            raise error.tlog_stopped("locked while awaiting version")
        from ..sim.loop import Future

        out = Future()

        def wake(_f) -> None:
            if not out._ready:
                out._set(None)

        self.version.when_at_least(version).on_ready(wake)
        stop_f = self._stop_promise.future
        stop_f.on_ready(wake)
        try:
            await out
        finally:
            stop_f.remove_callback(wake)
        if self.version.get() < version:
            raise error.tlog_stopped("locked while awaiting version")

    async def queue_info(self, _req):
        """Queue depth for the ratekeeper (the reference's TLogQueueInfo
        via getQueuingMetrics): in-memory index bytes + spill watermark."""
        from .ratekeeper import TLogQueueInfo

        return TLogQueueInfo(mem_bytes=self._mem_bytes,
                             spilled_version=self.spilled_version,
                             version=self.version.get())

    async def advance_known_committed(self, req: TLogKnownCommittedRequest) -> None:
        """The proxy reports all replicas acked `version` (the reference
        piggybacks this on the next push; a dedicated message keeps peeks
        moving on an idle system)."""
        if self.stopped:
            return
        v = min(req.version, self.version.get())
        if v > self.known_committed.get():
            self.known_committed.set(v)

    # -- read path -----------------------------------------------------------
    async def peek(self, req: TLogPeekRequest) -> TLogPeekReply:
        """Messages for req.tag with version >= begin_version, clipped to
        the known-committed horizon so nothing recovery could discard is
        ever served (blocks until the horizon passes begin_version)."""
        await self.known_committed.when_at_least(req.begin_version)
        if buggify.buggify():
            await delay(0.05, TaskPriority.TLOG_PEEK)  # slow peek service
        data = self.tag_data.get(req.tag, [])
        horizon = min(self.version.get(), self.known_committed.get())
        if buggify.buggify() and horizon > req.begin_version:
            # short peek page: serve a clipped horizon so consumers must
            # re-peek (the reference's peek reply byte limit)
            horizon = req.begin_version
        begin = max(req.begin_version, self.popped.get(req.tag, 0) + 1)
        spilled, truncated = await self._spilled_messages(req.tag, begin, horizon)
        if truncated and spilled:
            # partial spill read: serve what we have and clip the horizon so
            # the peeker resumes exactly after the last served version
            horizon = spilled[-1][0]
        msgs = spilled + [(v, m) for (v, m) in data
                          if begin <= v <= horizon and v > self.spilled_version]
        return TLogPeekReply(messages=msgs, end_version=horizon)

    async def pop(self, req: TLogPopRequest) -> None:
        if req.version < 0:
            # Tag retired (its shard moved away, MoveKeys finish): forget it
            # entirely so the queue front no longer waits on it.
            self._retired_tags.add(req.tag)
            self.tag_data.pop(req.tag, None)
            self.popped.pop(req.tag, None)
            self.tags_seen.discard(req.tag)
            await self._advance_queue_front()
            await self._persist_side_state(force=True)
            return
        if req.tag in self._retired_tags:
            return  # straggler pop from the retired replica's update loop
        prev = self.popped.get(req.tag, 0)
        if req.version <= prev:
            return
        self.popped[req.tag] = req.version
        self.tags_seen.add(req.tag)
        data = self.tag_data.get(req.tag)
        if data:
            self.tag_data[req.tag] = [(v, m) for (v, m) in data if v > req.version]
        if self._spill_store is not None:
            # lazily durable (uncommitted clears are memtable-visible; a
            # crash only re-serves acknowledged rows)
            self._spill_store.clear_range(
                _spill_key(req.tag, 0),
                _spill_key(req.tag, min(req.version, self.spilled_version) + 1))
        await self._advance_queue_front()
        await self._persist_side_state()

    # -- epoch end -----------------------------------------------------------
    async def lock(self, req: TLogLockRequest) -> TLogLockReply:
        """reference: tLogLock (TLogServer.actor.cpp:496). Idempotent. The
        lock is made DURABLE before the reply: the recovering master's
        min(end) math counts on this replica rejecting pushes forever,
        across its own reboots."""
        if buggify.buggify():
            # slow lock ack: the recovering master's lock fan-out completes
            # ragged, and commits mid-fsync see the stop flag at odd points
            await delay(0.05, TaskPriority.TLOG_COMMIT)
        self.stopped = True
        if not self._stop_promise.is_set:
            self._stop_promise.send(None)
        # EVERY lock reply waits for a durable stopped flag — a retried or
        # concurrent lock must not ack off the back of a first caller's
        # still-in-flight fsync (the persist mutex serializes; re-persisting
        # an already-durable flag is a no-op-shaped small write)
        await self._persist_side_state(force=True)
        return TLogLockReply(
            gen_id=self.gen_id,
            known_committed=self.known_committed.get(),
            end_version=self.version.get(),
        )

    async def recovery_data(self, req: TLogRecoveryDataRequest) -> TLogRecoveryDataReply:
        """All un-popped data up to the recovery version, for seeding the
        next generation (the copy replaces the reference's old-generation
        peek cursors) — INCLUDING the spilled tier, which holds the oldest
        part of the un-popped window (the reference's recovery peeks read
        through the persistent store the same way)."""
        clip = req.end_version
        out: Dict[int, list] = {}
        for tag in self.tags_seen:
            if tag in self._retired_tags:
                continue
            begin = self.popped.get(tag, 0) + 1
            spilled, truncated = await self._spilled_messages(tag, begin, clip)
            while truncated:
                more, truncated = await self._spilled_messages(
                    tag, spilled[-1][0] + 1, clip)
                spilled.extend(more)
            mem = [(v, m) for (v, m) in self.tag_data.get(tag, [])
                   if v <= clip and v > self.spilled_version]
            if spilled or mem:
                out[tag] = spilled + mem
        return TLogRecoveryDataReply(
            tag_data=out,
            popped=dict(self.popped),
        )
