"""Storage server: MVCC window over a durable ordered engine.

Port of ``foundationdb_tpu/server/storage.py``.

Re-design of fdbserver/storageserver.actor.cpp with the reference's actual
memory/durability split (round-4: the RAM-resident round-3 design is gone):

  * a per-key version-chain overlay (VersionedMap's role) holds ONLY the
    mutations in (durable_version, latest] — the MVCC read window;
  * a durable LSM engine (kvstore.SSTableStore, the KeyValueStoreSQLite
    role) holds the full dataset at exactly durable_version;
  * the update loop pulls the tag (update:2340) and applies to the overlay;
    a durability cycle (updateStorage:2585) writes resolved mutations up to
    latest - storage_durability_lag_versions into the engine, commits,
    advances oldest_version to the new durable_version, drops the covered
    overlay entries, and pops the tlog (tLogPop:898) — so reads at any
    version in [durable, latest] merge engine state with the overlay
    (readRange:936), RAM holds only the window, and crash recovery replays
    only the tag tail above durable, never the whole history.

Reads wait for the requested version (waitForVersion:644) and reject
out-of-window versions with transaction_too_old / future_version.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ..core import buggify, error, wire
from ..core.stats import CounterCollection
from ..core.types import (
    MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
    Key,
    KeyRange,
    Mutation,
    MutationType,
    STORAGE_ATOMIC_MUTATIONS,
    Value,
    Version,
    apply_atomic_op,
)
from ..sim.actors import AsyncMutex, AsyncVar, NotifiedVersion
from ..sim.loop import TaskPriority, delay, spawn
from ..sim.network import Endpoint, SimProcess
from .disk_queue import DiskQueue
from .log_system import LogSystemClient, LogSystemConfig
from .messages import (
    GetKeyValuesReply,
    GetKeyValuesRequest,
    GetValueReply,
    GetValueRequest,
)

from dataclasses import dataclass


@dataclass
class ShrinkShardRequest:
    """Give up [new_end, shard.end) after a split moved it away."""
    tag: int
    new_end: Key


@dataclass
class ExtendShardRequest:
    """Absorb [shard.end, new_end) from the retiring upper team (merge)."""
    tag: int
    new_end: Key
    fetch_from: List[str]
    fetch_version: Version


GET_VALUE_TOKEN = "storage.getValue"
GET_KEY_VALUES_TOKEN = "storage.getKeyValues"
WATCH_VALUE_TOKEN = "storage.watchValue"
STORAGE_METRICS_TOKEN = "storage.metrics"
SHRINK_SHARD_TOKEN = "storage.shrinkShard"
EXTEND_SHARD_TOKEN = "storage.extendShard"

#: how far ahead of the storage version a read may wait before future_version
#: (reference: storageserver waitForVersion MVCC window)
MAX_READ_AHEAD_VERSIONS = MAX_WRITE_TRANSACTION_LIFE_VERSIONS
#: parked watches expire server-side after this long; below the client's 30s
#: request timeout so a live client re-registers before its entry dies here
WATCH_EXPIRE_SECONDS = 25.0


class VersionedStore:
    """Sorted keys, each with an append-only (version, value|None) chain;
    None = cleared. The logical content at version V is the last entry <= V
    of every chain. Plays VersionedMap's role with plain bisect structures —
    adequate for simulation scale; the Pallas/native engines replace it in
    the storage-engine round."""

    def __init__(self) -> None:
        self._keys: List[Key] = []
        self._chains: Dict[Key, List[Tuple[Version, Optional[Value]]]] = {}
        #: version-stamped range tombstones [(version, begin, end)]: as an
        #: OVERLAY over a durable engine, a clear must mask engine keys the
        #: overlay has no chain for (chains alone were only correct when
        #: they held the whole dataset)
        self._tombs: List[Tuple[Version, Key, Key]] = []
        self.oldest_version: Version = 0

    def _chain(self, key: Key) -> List[Tuple[Version, Optional[Value]]]:
        c = self._chains.get(key)
        if c is None:
            bisect.insort(self._keys, key)
            c = self._chains[key] = []
        return c

    def value_at(self, key: Key, version: Version) -> Optional[Value]:
        c = self._chains.get(key)
        if not c:
            return None
        i = bisect.bisect_right(c, version, key=lambda e: e[0]) - 1
        if i < 0:
            return None
        return c[i][1]

    def set(self, key: Key, value: Value, version: Version) -> None:
        self._chain(key).append((version, value))

    def clear_range(self, begin: Key, end: Key, version: Version) -> None:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            c = self._chains[k]
            if c and c[-1][1] is not None:
                c.append((version, None))
        self._tombs.append((version, begin, end))

    def range_at(
        self, begin: Key, end: Key, version: Version, limit: int, reverse: bool = False
    ) -> Tuple[List[Tuple[Key, Value]], bool]:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        keys = self._keys[lo:hi]
        if reverse:
            keys = list(reversed(keys))
        out: List[Tuple[Key, Value]] = []
        for i, k in enumerate(keys):
            v = self.value_at(k, version)
            if v is not None:
                out.append((k, v))
                if len(out) >= limit:
                    return out, i + 1 < len(keys)
        return out, False

    def snapshot_items(self, version: Version) -> List[Tuple[Key, Value]]:
        """Flattened live content at `version` (for durable snapshots)."""
        out: List[Tuple[Key, Value]] = []
        for k in self._keys:
            v = self.value_at(k, version)
            if v is not None:
                out.append((k, v))
        return out

    def load_snapshot(self, items: List[Tuple[Key, Value]], version: Version) -> None:
        self._keys = sorted(k for k, _ in items)
        self._chains = {k: [(version, v)] for k, v in items}
        self._tombs = []
        self.oldest_version = version

    def forget_before(self, version: Version) -> None:
        """Drop history below `version`, keeping each chain's latest entry at
        or below it (the storage analog of removeBefore) — the memory-mode
        rule, where chains ARE the dataset."""
        self.oldest_version = max(self.oldest_version, version)
        self._tombs = [t for t in self._tombs if t[0] > version]
        dead: List[Key] = []
        for k, c in self._chains.items():
            i = bisect.bisect_right(c, version, key=lambda e: e[0]) - 1
            if i > 0:
                del c[: i]
            if len(c) == 1 and c[0][1] is None:
                dead.append(k)
        for k in dead:
            del self._chains[k]
            i = bisect.bisect_left(self._keys, k)
            del self._keys[i]

    def entry_at(self, key: Key, version: Version) -> Optional[Tuple[Version, Optional[Value]]]:
        """Latest overlay fact about `key` at or below `version` — a chain
        entry or a range tombstone, whichever is newer (chains win ties:
        within one version, mutations applied later appended later). None
        means the overlay has nothing to say and the engine answers."""
        ce = None
        c = self._chains.get(key)
        if c:
            i = bisect.bisect_right(c, version, key=lambda e: e[0]) - 1
            if i >= 0:
                ce = c[i]
        if not self._tombs:     # common case: clear-free window
            return ce
        tv = -1
        for v, b, e in self._tombs:
            if v <= version and b <= key < e and v > tv:
                tv = v
        if ce is not None and (tv < 0 or ce[0] >= tv):
            return ce
        if tv >= 0:
            return (tv, None)
        return ce

    def drop_through(self, version: Version) -> None:
        """Durable-mode trim: entries <= `version` are now in the engine, so
        they leave the overlay ENTIRELY (no anchors — the engine at
        durable_version is the base the overlay patches)."""
        self.oldest_version = max(self.oldest_version, version)
        self._tombs = [t for t in self._tombs if t[0] > version]
        dead: List[Key] = []
        for k, c in self._chains.items():
            i = bisect.bisect_right(c, version, key=lambda e: e[0])
            if i > 0:
                del c[:i]
            if not c:
                dead.append(k)
        for k in dead:
            del self._chains[k]
            i = bisect.bisect_left(self._keys, k)
            del self._keys[i]

    def drop_through_range(self, begin: Key, end: Key) -> None:
        """Forget every chain in [begin, end) — the range left this shard
        (split shrink); out-of-shard tombs are harmless and expire with
        the window."""
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._chains[k]
        del self._keys[lo:hi]

    def overlay_keys(self, begin: Key, end: Key) -> List[Key]:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return self._keys[lo:hi]


#: the engine's private keyspace: strictly above every servable shard end
#: (cluster shards end at b"\xff\xff\xff"), so range reads never see it —
#: the analog of the reference's persistent-format keys in its own KVS
STORAGE_PRIVATE_PREFIX = b"\xff\xff\xff\xff/"
DURABLE_VERSION_KEY = STORAGE_PRIVATE_PREFIX + b"durableVersion"
READ_FLOOR_KEY = STORAGE_PRIVATE_PREFIX + b"readFloor"


class StorageServer:
    #: durability cycle fires when the overlay backlog exceeds this
    #: (memory pressure overrides the version-lag cadence)
    PENDING_BYTES = 1 << 20

    def __init__(
        self,
        proc: SimProcess,
        tag: int,
        shard: KeyRange,
        log_view: AsyncVar,
        net,
        start_version: Version = 0,
        disk=None,
        kvs=None,
        defer_update_loop: bool = False,
    ):
        """`log_view` is an AsyncVar[LogSystemConfig | None]: the current
        log generation to pull from. Recovery re-points it (the worker's
        ServerDBInfo watch), and the update loop follows — the analog of
        the reference storage server tracking the log system through
        ServerDBInfo broadcasts (storageserver.actor.cpp update:2340)."""
        self.proc = proc
        self.tag = tag
        self.shard = shard
        self.net = net
        self.log_view = log_view
        self.store = VersionedStore()
        #: reference: StorageServer::Counters (storageserver.actor.cpp)
        self.stats = CounterCollection("Storage", f"tag{tag}")
        self.version = NotifiedVersion(start_version)
        #: durable (engine-committed) version: the tlog may only be popped
        #: to here, and oldest_version tracks it in durable mode
        self.durable_version: Version = start_version
        #: durable engine (kvstore.SSTableStore) or None = memory mode
        self.kvs = kvs
        #: resolved ops per version awaiting the durability cycle:
        #: [(version, [(0,k,v)|(1,b,e)], bytes)]
        self._pending: List[Tuple[Version, list, int]] = []
        self._pending_bytes = 0
        #: a durability cycle is mid-flight toward this version: reads below
        #: it must not consult the half-mutated engine (see _read_floor)
        self._durabilizing_to: Version = 0
        #: serializes _make_durable: the update loop's durability cycle and
        #: extend_shard's replay flush both scan/trim _pending across
        #: engine-commit awaits
        self._durable_mutex = AsyncMutex()
        #: an extend_shard fetch is in flight for (begin, end, buffer):
        #: tag mutations for the incoming range are buffered here instead
        #: of being dropped by the shard-bounds guard (AddingShard's double
        #: buffer, storageserver.actor.cpp:77)
        self._adding: Optional[Tuple[Key, Key, list]] = None
        #: byte sample (storageserver.actor.cpp:2776 byteSampleApplySet):
        #: each written key is sampled with probability size/FACTOR and
        #: carries weight FACTOR — total bytes and split points come from
        #: the sample, never from scanning the dataset
        from ..core.indexedset import IndexedSet

        #: order-statistic byte sample (flow/IndexedSet.h backing
        #: StorageMetrics): metric sums give the total and the median
        #: split key in O(log n), not a per-poll sort
        self.byte_sample = IndexedSet()
        #: write-bandwidth sample (StorageMetrics' bytesPerKSecond role):
        #: bytes of applied mutations since the last DD poll; the tracker
        #: divides by the poll gap for a rate
        self._bw_bytes: int = 0
        self._bw_last_poll: float = 0.0
        self._disk = disk
        self._update_task = None
        self._tokens = [GET_VALUE_TOKEN, GET_KEY_VALUES_TOKEN, WATCH_VALUE_TOKEN,
                        "storage.stats"]
        proc.register(GET_VALUE_TOKEN, self.get_value)
        proc.register(GET_KEY_VALUES_TOKEN, self.get_key_values)
        #: parked watches: key -> [(expected value, Promise)]
        self._watches: Dict[Key, List] = {}
        proc.register(WATCH_VALUE_TOKEN, self.watch_value)
        from .ratekeeper import STORAGE_QUEUE_INFO_TOKEN, StorageQueueInfo

        async def queue_info(_req):
            return StorageQueueInfo(
                tag=self.tag, version=self.version.get(),
                durable_version=self.durable_version,
                queue_bytes=self._pending_bytes,
            )

        async def stats_req(_req):
            return self.stats.as_dict()

        proc.register("storage.stats", stats_req)
        proc.register(STORAGE_METRICS_TOKEN, self.storage_metrics)
        proc.register(SHRINK_SHARD_TOKEN, self.shrink_shard)
        proc.register(EXTEND_SHARD_TOKEN, self.extend_shard)
        self._tokens += [STORAGE_METRICS_TOKEN, SHRINK_SHARD_TOKEN,
                         EXTEND_SHARD_TOKEN]

        proc.register(STORAGE_QUEUE_INFO_TOKEN, queue_info)
        self._tokens.append(STORAGE_QUEUE_INFO_TOKEN)
        if not defer_update_loop:
            self.start_update_loop()

    def start_update_loop(self) -> None:
        self._update_task = spawn(self.update_loop(), TaskPriority.STORAGE,
                                  name=f"ss-update:{self.tag}")
        self.proc.actors.add(self._update_task)

    def retire(self) -> None:
        """This replica's shard moved away (MoveKeys finish): stop serving,
        stop pulling the tag, drop the disk footprint."""
        for tok in self._tokens:
            self.proc.unregister(tok)
        if self._update_task is not None:
            self._update_task.cancel()
        for parked in self._watches.values():
            for _expected, p in parked:
                if not p.is_set:
                    p.send_error(error.watch_cancelled())
        self._watches.clear()
        if self.kvs is not None:
            self.kvs.destroy()
        if self._disk is not None:
            for suffix in (".meta", ".snap", ".snap.tmp", ".dq", ".dq.tmp"):
                self._disk.delete(self._meta_name() + suffix)

    async def _fetch_range(self, addrs: List[str], begin: Key, end: Key,
                           version: Version,
                           items: Optional[List[Tuple[Key, Value]]] = None) -> None:
        """Paged copy of [begin, end) at `version` from a serving team into
        the engine (durable mode; committed per page) or `items` (memory
        mode), with replica rotation + retries and BUGGIFY mid-copy pauses.
        Shared by fetchKeys and the merge path's extend (one fetch loop, one
        set of semantics)."""
        from ..core.types import key_after

        cb, ce = begin, end
        while cb < ce:
            reply = None
            last: Optional[error.FDBError] = None
            if buggify.buggify():
                # fetchKeys pauses mid-copy: the tag stream must buffer
                await delay(0.25, TaskPriority.FETCH_KEYS)
            for i in range(len(addrs) * 3):
                addr = addrs[i % len(addrs)]
                try:
                    reply = await self.net.request(
                        self.proc.address,
                        Endpoint(addr, GET_KEY_VALUES_TOKEN),
                        GetKeyValuesRequest(begin=cb, end=ce, version=version,
                                            limit=10_000),
                        TaskPriority.FETCH_KEYS, timeout=5.0,
                    )
                    break
                except error.FDBError as e:
                    last = e
                    await delay(0.2, TaskPriority.FETCH_KEYS)
            if reply is None:
                raise last if last is not None else error.connection_failed()
            for k, v in reply.data:
                if self.kvs is not None:
                    self.kvs.set(k, v)
                else:
                    items.append((k, v))
                self._sample_set(k, v)
            if self.kvs is not None:
                await self.kvs.commit()
            if not reply.more or not reply.data:
                break
            cb = key_after(reply.data[-1][0])

    async def fetch_keys(self, addrs: List[str], version: Version) -> None:
        """Populate this fresh replica with its shard's contents at
        `version`, read from the serving team (fetchKeys,
        storageserver.actor.cpp:1777). The AddingShard double buffer is the
        log system itself here: this tag's mutations > `version` are
        already accumulating at the tlogs and the update loop consumes them
        once this snapshot is loaded. In durable mode the copy streams into
        the engine (a retried half-fetch starts from a cleared shard)."""
        if self.kvs is not None:
            self.kvs.clear_range(self.shard.begin, self.shard.end)
        items: List[Tuple[Key, Value]] = []
        await self._fetch_range(addrs, self.shard.begin, self.shard.end,
                                version, items)
        if self.kvs is not None:
            self.kvs.set(DURABLE_VERSION_KEY, wire.dumps(version))
            await self.kvs.commit()
            self.store = VersionedStore()
            self.store.oldest_version = version
        else:
            self.store.load_snapshot(items, version)
        self.version = NotifiedVersion(version)
        self.durable_version = version

    # -- durability ----------------------------------------------------------
    def _meta_name(self) -> str:
        return f"storage-{self.tag}"

    @classmethod
    async def create(cls, proc: SimProcess, tag: int, shard: KeyRange,
                     log_view: AsyncVar, net, disk,
                     start_version: Version = 0,
                     defer_update_loop: bool = False) -> "StorageServer":
        """Fresh durable-mode server: open (or re-open) the engine."""
        from .kvstore import SSTableStore

        kvs = await SSTableStore.open(disk, f"storage-{tag}")
        return cls(proc, tag=tag, shard=shard, log_view=log_view, net=net,
                   start_version=start_version, disk=disk, kvs=kvs,
                   defer_update_loop=defer_update_loop)

    async def persist_initial(self) -> None:
        if self._disk is None:
            return
        meta = self._disk.open(self._meta_name() + ".meta")
        await meta.write(0, wire.dumps({
            "tag": self.tag, "begin": self.shard.begin, "end": self.shard.end,
        }))
        await meta.sync()
        if self.kvs is not None and await self.kvs.get(DURABLE_VERSION_KEY) is None:
            self.kvs.set(DURABLE_VERSION_KEY, wire.dumps(self.durable_version))
            await self.kvs.commit()

    def _purge_pending_outside(self) -> None:
        """Clip every pending durability op to the current shard bounds."""
        b, e = self.shard.begin, self.shard.end
        new_pending = []
        self._pending_bytes = 0
        for v, ops, _nb in self._pending:
            kept = []
            nbytes = 0
            for op in ops:
                if op[0] == 0:
                    if op[2] is None or not (b <= op[1] < e):
                        continue
                    kept.append(op)
                else:
                    cb, ce = max(op[1], b), min(op[2], e)
                    if cb >= ce:
                        continue
                    kept.append((1, cb, ce))
                nbytes += len(kept[-1][1]) + len(kept[-1][2] or b"") + 24
            new_pending.append((v, kept, nbytes))
            self._pending_bytes += nbytes
        self._pending = new_pending

    async def _make_durable(self, target: Version) -> None:
        """updateStorage:2585: push resolved ops <= target into the engine,
        commit (the durability point), advance the MVCC floor, trim the
        overlay, and let the caller pop the tlog."""
        async with self._durable_mutex:
            await self._make_durable_locked(target)

    async def _make_durable_locked(self, target: Version) -> None:
        i = 0
        new_durable = self.durable_version
        for v, _ops, _nb in self._pending:
            if v > target:
                break
            # max, not assignment: extend_shard's buffered replay may have
            # queued versions BELOW the current durable floor (durability
            # advanced during its fetch) — writing them is correct (their
            # keys are in the just-absorbed range, untouched above), but
            # the floor itself must never regress
            new_durable = max(new_durable, v)
            i += 1
        if i == 0:
            return
        # Raise the read floor BEFORE touching the engine: the memtable
        # makes each set visible immediately, so a concurrent read below
        # new_durable falling through to the engine could otherwise observe
        # a higher version's write. Reads past the gate re-check the floor
        # after their engine await (get_value/get_key_values).
        self._durabilizing_to = max(self._durabilizing_to, new_durable)
        self.store.oldest_version = max(self.store.oldest_version, new_durable)
        for v, ops, nbytes in self._pending[:i]:
            for op in ops:
                if op[0] == 0:
                    if op[2] is not None:
                        self.kvs.set(op[1], op[2])
                else:
                    self.kvs.clear_range(op[1], op[2])
            self._pending_bytes -= nbytes
        del self._pending[:i]
        self.kvs.set(DURABLE_VERSION_KEY, wire.dumps(new_durable))
        if buggify.buggify():
            # stall between staging and the engine fsync: reads that
            # awaited across this window must re-check the floor, and a
            # crash here loses the whole staged batch (tlog not yet popped)
            await delay(0.05, TaskPriority.STORAGE)
        await self.kvs.commit()
        self.durable_version = new_durable
        self.store.drop_through(new_durable)

    @classmethod
    async def restore(cls, proc: SimProcess, disk, meta_name: str,
                      log_view: AsyncVar, net) -> Optional["StorageServer"]:
        """Reboot recovery: the engine IS the state at durable_version; the
        update loop replays only the tag tail above it from the tlogs —
        restart cost is the durability lag, never the dataset size."""
        meta_file = disk.open(meta_name)
        raw = await meta_file.read(0, meta_file.size())
        try:
            meta = wire.loads(raw)
        except Exception:
            return None
        from .kvstore import SSTableStore

        kvs = await SSTableStore.open(disk, f"storage-{meta['tag']}")
        raw = await kvs.get(DURABLE_VERSION_KEY)
        durable = wire.loads(raw) if raw is not None else 0
        ss = cls(proc, tag=meta["tag"], shard=KeyRange(meta["begin"], meta["end"]),
                 log_view=log_view, net=net, start_version=durable, disk=disk,
                 kvs=kvs)
        ss.durable_version = durable
        ss.store.oldest_version = durable
        floor = await kvs.get(READ_FLOOR_KEY)
        if floor is not None:
            ss._durabilizing_to = max(ss._durabilizing_to, wire.loads(floor))
        return ss

    # -- write path ----------------------------------------------------------
    def _fire_watches(self, key: Key, new_value: Optional[Value]) -> None:
        """Wake watchers whose expected value no longer matches
        (watchValue:773 triggers on change)."""
        parked = self._watches.get(key)
        if not parked:
            return
        still = []
        for expected, promise in parked:
            if expected != new_value:
                if not promise.is_set:
                    promise.send(new_value)
            else:
                still.append((expected, promise))
        if still:
            self._watches[key] = still
        else:
            del self._watches[key]

    # -- byte sample + DD metrics -------------------------------------------
    def _sample_set(self, key: Key, value: Optional[Value]) -> None:
        from ..core.knobs import SERVER_KNOBS
        from ..sim.loop import current_scheduler

        if value is None:
            self.byte_sample.erase(key)
            return
        size = len(key) + len(value)
        factor = max(1, SERVER_KNOBS.dd_byte_sample_factor)
        # deterministic per seed: the sim RNG drives sampling
        if size >= factor or current_scheduler().rng.random01() < size / factor:
            self.byte_sample.insert(key, max(size, factor))   # replaces
        else:
            self.byte_sample.erase(key)   # re-rolled OUT of the sample

    @property
    def sampled_bytes(self) -> int:
        return self.byte_sample.total()

    def _sample_clear(self, begin: Key, end: Key) -> None:
        self.byte_sample.erase_range(begin, end)

    async def storage_metrics(self, _req) -> dict:
        """Per-shard size estimate, a median split point from the byte
        sample, and the applied-write bandwidth since the last poll (the
        DD tracker's WaitMetrics/SplitMetrics + bytesPerKSecond, reduced
        to polling; reference: StorageMetrics.actor.h)."""
        from ..sim.loop import now as _now

        t = _now()
        gap = max(t - self._bw_last_poll, 1e-6)
        write_bw = self._bw_bytes / gap if self._bw_last_poll else 0.0
        self._bw_bytes = 0
        self._bw_last_poll = t
        split = self.byte_sample.split_key()
        if split is not None and split <= self.shard.begin:
            # a split at the very first key would produce an empty lower
            # half; shard begin is excluded
            split = None
        return {
            "tag": self.tag,
            "begin": self.shard.begin,
            "end": self.shard.end,
            "bytes": self.sampled_bytes,
            "write_bw": write_bw,
            "mutations": self.stats.as_dict().get("mutations", 0),
            "split_key": split,
        }

    # -- shard reshaping (DD split/merge) ------------------------------------
    async def shrink_shard(self, req) -> None:
        """Give up [new_end, end): the upper half moved to a new team
        (split). Data beyond the new bound is dropped everywhere."""
        old_end = self.shard.end
        new_end = req.new_end
        if not (self.shard.begin < new_end <= old_end):
            raise error.client_invalid_operation("shrink bound outside shard")
        self.shard = KeyRange(self.shard.begin, new_end)
        self._sample_clear(new_end, old_end)
        # overlay + engine drop the range; straggler tag mutations for it
        # are discarded by the _apply bounds guard from now on. Ops already
        # APPLIED but not yet durable must drop too — otherwise a later
        # durability cycle resurrects the range in the engine, where a
        # subsequent merge-extend would expose it (pre-shrink values that
        # never saw the clears clipped away by the bounds guard).
        self._purge_pending_outside()
        self.store.clear_range(new_end, old_end, self.version.get())
        self.store.drop_through_range(new_end, old_end)
        if self.kvs is not None:
            self.kvs.clear_range(new_end, old_end)
            await self.kvs.commit()
        if self._disk is not None:
            meta = self._disk.open(self._meta_name() + ".meta")
            await meta.write(0, wire.dumps({
                "tag": self.tag, "begin": self.shard.begin,
                "end": self.shard.end,
            }))
            await meta.sync()

    async def extend_shard(self, req) -> None:
        """Absorb [end, new_end) from `fetch_from` at `fetch_version` (the
        merge path). AddingShard semantics (storageserver.actor.cpp:77):
        this team's tags were added to the upper shard before the fetch, so
        mutations for the incoming range arrive DURING the paged fetch —
        they are buffered (the shard-bounds guard would otherwise drop them
        and the version watermark would advance past them forever) and
        replayed in version order on top of the fetched base, and only then
        does the range join the shard."""
        old_end = self.shard.end
        if not (old_end <= req.new_end):
            raise error.client_invalid_operation("extend bound inside shard")
        if self._adding is not None:
            raise error.client_invalid_operation("extend already in flight")
        buf: list = []
        self._adding = (old_end, req.new_end, buf)
        try:
            if self.kvs is not None:
                # a retried half-fetch must not leave stale rows from the
                # aborted attempt under the fresh snapshot
                self.kvs.clear_range(old_end, req.new_end)
            items: List[Tuple[Key, Value]] = []
            await self._fetch_range(req.fetch_from, old_end, req.new_end,
                                    req.fetch_version, items)
        except BaseException:
            self._adding = None   # master retries; a re-fetch starts clean
            raise
        try:
            if buggify.buggify():
                # widen the fetch-to-replay gap: more tag mutations land in
                # the AddingShard buffer, stressing the replay version merge
                await delay(0.5, TaskPriority.FETCH_KEYS)
            if self.kvs is None:
                # fetched base BEFORE the buffered replay: chains stay monotone
                for k, v in items:
                    self.store.set(k, v, req.fetch_version)
            # Replay buffered mutations above the snapshot version. The
            # buffer may still grow during an atomic op's engine read; the
            # index loop drains the tail too, and _adding stays active
            # throughout so the update loop keeps routing new-range
            # mutations here (an older buffered write can never land after
            # a newer live one).
            per_version: Dict[Version, list] = {}
            i = 0
            while i < len(buf):
                v, m = buf[i]
                i += 1
                if v <= req.fetch_version:
                    continue   # already contained in the fetched snapshot
                op = await self._apply(m, v, unbounded=True)
                if self.kvs is not None:
                    per_version.setdefault(v, []).append(op)
        except BaseException:
            # A dangling buffer would reject every retried extend and eat
            # the incoming range's mutations forever; the retry re-fetches
            # from a cleared engine range and a fresh buffer. (Replayed
            # overlay entries beyond the un-widened shard are invisible to
            # reads and age out with the window.)
            self._adding = None
            raise
        self._adding = None
        self.shard = KeyRange(self.shard.begin, req.new_end)
        # Replayed ops enter the durability pipeline at their versions
        # (merge-sorted into _pending; a same-version entry may already
        # exist from the commit's in-shard portion — the ranges are
        # disjoint, so appending preserves apply semantics).
        for v in sorted(per_version):
            ops = per_version[v]
            nbytes = sum(len(op[1]) + len(op[2] or b"") + 24 for op in ops)
            j = bisect.bisect_left(self._pending, v, key=lambda e: e[0])
            if j < len(self._pending) and self._pending[j][0] == v:
                ev, eops, enb = self._pending[j]
                self._pending[j] = (ev, eops + ops, enb + nbytes)
            else:
                self._pending.insert(j, (v, ops, nbytes))
            self._pending_bytes += nbytes
        if self.kvs is not None and per_version:
            # The replayed versions may already be POPPED from the tlog
            # (in-shard durability advanced during the fetch and popped
            # past them); until they hit the engine they exist only in
            # this process's RAM. Force them durable BEFORE acking the
            # extend — a crash after the ack must not lose them, and the
            # master retires the donor team on our ack.
            await self._make_durable(max(per_version))
        # The fetched rows reflect fetch_version; reads below it in the new
        # range would see the future. Raise the floor (persisted so a
        # restart keeps the gate) — retries get fresher read versions. The
        # floor must be engine-durable BEFORE the extended meta syncs: a
        # crash between the two would otherwise restore the wider shard
        # with the stale floor and serve the fetch snapshot to reads below
        # fetch_version (read-from-the-future).
        self._durabilizing_to = max(self._durabilizing_to, req.fetch_version)
        if self.kvs is not None:
            self.kvs.set(READ_FLOOR_KEY, wire.dumps(self._durabilizing_to))
            await self.kvs.commit()
        if self._disk is not None:
            meta = self._disk.open(self._meta_name() + ".meta")
            await meta.write(0, wire.dumps({
                "tag": self.tag, "begin": self.shard.begin,
                "end": self.shard.end,
            }))
            await meta.sync()

    async def _existing_value(self, key: Key, version: Version) -> Optional[Value]:
        """Current value for an atomic-op read-modify-write: overlay entry
        if one covers `version`, else the durable engine (doEagerReads'
        read-before-apply, storageserver.actor.cpp:1370)."""
        e = self.store.entry_at(key, version)
        if e is not None:
            return e[1]
        if self.kvs is not None:
            return await self.kvs.get(key)
        return None

    async def _apply(self, m: Mutation, version: Version,
                     unbounded: bool = False) -> Optional[tuple]:
        """Apply one mutation to the overlay; returns the RESOLVED op for
        the durability cycle ((0, k, v) set / (1, b, e) clear) — atomic ops
        are materialized here, so the engine only ever stores values.
        `unbounded` (extend_shard's buffered replay) skips the shard-bounds
        guard: the mutation's range joins the shard only when the replay
        finishes, but its keys are already clipped to the incoming range."""
        if not unbounded and self._adding is not None:
            ab, ae, buf = self._adding
            if m.type == MutationType.CLEAR_RANGE:
                cb, ce = max(m.param1, ab), min(m.param2, ae)
                if cb < ce:
                    buf.append((version, Mutation(
                        type=MutationType.CLEAR_RANGE, param1=cb, param2=ce)))
                # fall through: the in-shard portion still applies below
            elif ab <= m.param1 < ae:
                buf.append((version, m))
                return (0, b"", None)
        if m.type == MutationType.SET_VALUE:
            if not unbounded and not self.shard.contains(m.param1):
                return (0, b"", None)    # straggler for a shrunk-away range
            self.store.set(m.param1, m.param2, version)
            self._bw_bytes += len(m.param1) + len(m.param2)
            self._sample_set(m.param1, m.param2)
            self._fire_watches(m.param1, m.param2)
            return (0, m.param1, m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            if unbounded:
                b, e = m.param1, m.param2
            else:
                b = max(m.param1, self.shard.begin)
                e = min(m.param2, self.shard.end)
            if b >= e:
                return (0, b"", None)
            self.store.clear_range(b, e, version)
            self._bw_bytes += len(b) + len(e)
            self._sample_clear(b, e)
            for k in [k for k in self._watches if b <= k < e]:
                self._fire_watches(k, None)
            return (1, b, e)
        elif m.type in STORAGE_ATOMIC_MUTATIONS:
            if not unbounded and not self.shard.contains(m.param1):
                return (0, b"", None)
            existing = await self._existing_value(m.param1, version)
            new = apply_atomic_op(m.type, existing, m.param2)
            self.store.set(m.param1, new, version)
            self._bw_bytes += len(m.param1) + len(new)
            self._sample_set(m.param1, new)
            self._fire_watches(m.param1, new)
            return (0, m.param1, new)
        else:
            # Versionstamped mutations must have been rewritten to SET_VALUE
            # by the proxy (transform_versionstamp_mutation) before logging.
            raise error.client_invalid_operation(f"unsupported mutation {m.type}")

    async def update_loop(self) -> None:
        """Pull this server's tag from the tlog forever (update:2340), then
        run the durability cycle (updateStorage:2585). Peeks are idempotent,
        so transport loss (tlog death, partition, timeout) just retries; a
        blocked peek is re-armed every few virtual seconds so a
        partitioned-then-healed link recovers."""
        while True:
            cfg = self.log_view.get()
            if cfg is None:
                await self.log_view.on_change()
                continue
            client = LogSystemClient(self.net, self.proc.address, cfg)
            try:
                reply = await client.peek(self.tag, self.version.get() + 1)
            except error.FDBError:
                # tlog death / partition / generation turnover: re-read the
                # view and retry (peeks are idempotent).
                await delay(0.5, TaskPriority.TLOG_PEEK)
                continue
            for v, muts in reply.messages:
                if v <= self.version.get():
                    continue
                if self.kvs is None:
                    for m in muts:
                        await self._apply(m, v)
                else:
                    ops = []
                    nbytes = 0
                    for m in muts:
                        op = await self._apply(m, v)
                        ops.append(op)
                        nbytes += len(op[1]) + len(op[2] or b"") + 24
                    self._pending.append((v, ops, nbytes))
                    self._pending_bytes += nbytes
                self.stats.add("mutations", len(muts))
            if reply.end_version > self.version.get():
                self.version.set(reply.end_version)
                if self.kvs is None:
                    window = self.version.get() - MAX_WRITE_TRANSACTION_LIFE_VERSIONS
                    if window > 0:
                        self.store.forget_before(window)
                    self.durable_version = self.version.get()
                    client.pop(self.tag, self.durable_version)
                else:
                    from ..core.knobs import SERVER_KNOBS

                    lag = SERVER_KNOBS.storage_durability_lag_versions
                    if buggify.buggify():
                        lag = 100  # an eager flusher stresses the floor
                    target = self.version.get() - lag
                    limit = 1024 if buggify.buggify() else self.PENDING_BYTES
                    if self._pending_bytes > limit:
                        # memory pressure: drain everything applied so far
                        target = self.version.get()
                    if self._pending and target >= self._pending[0][0]:
                        await self._make_durable(target)
                    client.pop(self.tag, self.durable_version)

    # -- read path -----------------------------------------------------------
    async def _wait_for_version(self, version: Version) -> None:
        """reference: waitForVersion, storageserver.actor.cpp:644."""
        if version < self._read_floor():
            raise error.transaction_too_old()
        if version > self.version.get() + MAX_READ_AHEAD_VERSIONS:
            raise error.future_version()
        await self.version.when_at_least(version)

    def _check_shard(self, begin: Key, end: Key) -> None:
        if begin < self.shard.begin or end > self.shard.end:
            raise error.wrong_shard_server()

    async def _value_at(self, key: Key, version: Version) -> Optional[Value]:
        """Overlay entry at `version` wins; otherwise the durable engine
        (the getValueQ read merge, storageserver.actor.cpp:697)."""
        e = self.store.entry_at(key, version)
        if e is not None:
            return e[1]
        if self.kvs is not None:
            return await self.kvs.get(key)
        return None

    async def _range_at(
        self, begin: Key, end: Key, version: Version, limit: int, reverse: bool
    ) -> Tuple[List[Tuple[Key, Value]], bool]:
        """Range read merging the durable engine with the overlay
        (readRange:936: disk + VersionedMap). Overlay entries at or below
        `version` override engine values (None = cleared); overlay keys
        whose chains start after `version` defer to the engine."""
        if self.kvs is None:
            return self.store.range_at(begin, end, version, limit, reverse)
        from ..core.types import key_after

        okeys = self.store.overlay_keys(begin, end)
        if reverse:
            okeys = list(reversed(okeys))
        oi = 0
        out: List[Tuple[Key, Value]] = []
        cb, ce = begin, end
        exhausted = False
        while len(out) < limit and not exhausted:
            page, more = await self.kvs.get_range(cb, ce, max(limit - len(out), 16),
                                                  reverse=reverse)
            if not more:
                exhausted = True
            elif page:
                if reverse:
                    ce = page[-1][0]
                else:
                    cb = key_after(page[-1][0])
            for k, v in page:
                # overlay keys strictly before k (in scan order) are
                # overlay-only: emit their value if live at `version`
                while oi < len(okeys) and (
                    (okeys[oi] < k) if not reverse else (okeys[oi] > k)
                ):
                    e = self.store.entry_at(okeys[oi], version)
                    if e is not None and e[1] is not None:
                        out.append((okeys[oi], e[1]))
                        if len(out) >= limit:
                            break
                    oi += 1
                if len(out) >= limit:
                    break
                if oi < len(okeys) and okeys[oi] == k:
                    oi += 1
                # the overlay (chain entry OR range tombstone <= version)
                # overrides the engine value; otherwise the engine answers
                e = self.store.entry_at(k, version)
                if e is not None:
                    if e[1] is not None:
                        out.append((k, e[1]))
                else:
                    out.append((k, v))
                if len(out) >= limit:
                    break
            if len(out) >= limit:
                return out, True
        # trailing overlay-only keys past the engine's last page
        while oi < len(okeys) and len(out) < limit:
            e = self.store.entry_at(okeys[oi], version)
            if e is not None and e[1] is not None:
                out.append((okeys[oi], e[1]))
            oi += 1
        return out, oi < len(okeys)

    def _read_floor(self) -> Version:
        """Oldest readable version: the MVCC floor plus any durability
        cycle currently mutating the engine. Reads that awaited across a
        cycle must re-check (and retry via transaction_too_old) rather than
        return values a higher version wrote."""
        return max(self.store.oldest_version, self._durabilizing_to)

    async def get_value(self, req: GetValueRequest) -> GetValueReply:
        if not self.shard.contains(req.key):
            raise error.wrong_shard_server()
        await self._wait_for_version(req.version)
        self.stats.add("get_value")
        value = await self._value_at(req.key, req.version)
        if req.version < self._read_floor():
            raise error.transaction_too_old()
        return GetValueReply(value=value)

    async def watch_value(self, req) -> Optional[Value]:
        """Park until key's value differs from req.value; returns the new
        value (reference: watchValue, storageserver.actor.cpp:773). If the
        value already differs at this server's version, fires immediately —
        the client races with writers, exactly like the reference."""
        from ..sim.loop import Promise

        if not self.shard.contains(req.key):
            raise error.wrong_shard_server()
        await self._wait_for_version(req.version)
        current = await self._value_at(req.key, self.version.get())
        if current != req.value:
            return current
        p = Promise()
        entry = (req.value, p)
        self._watches.setdefault(req.key, []).append(entry)
        # Server-side expiry (reference: watchValue timeout / MAX_WATCHES):
        # a parked watch whose client timed out or died would otherwise sit
        # in _watches forever on a never-changing key.
        from ..sim.actors import any_of

        expiry = delay(WATCH_EXPIRE_SECONDS, TaskPriority.DEFAULT_ENDPOINT)
        idx, _ = await any_of([p.future, expiry])
        if idx == 0:
            # Fire the expiry future now so its callbacks drop; the stale
            # scheduler event retains only the (now ready) future itself.
            if not expiry.is_ready:
                expiry._set(None)
            return p.future.get()
        parked = self._watches.get(req.key)
        if parked is not None:
            try:
                parked.remove(entry)
            except ValueError:
                pass
            if not parked:
                del self._watches[req.key]
        raise error.watch_cancelled()

    async def get_key_values(self, req: GetKeyValuesRequest) -> GetKeyValuesReply:
        self._check_shard(req.begin, req.end)
        await self._wait_for_version(req.version)
        self.stats.add("get_range")
        data, more = await self._range_at(req.begin, req.end, req.version,
                                          req.limit, req.reverse)
        if req.version < self._read_floor():
            raise error.transaction_too_old()
        self.stats.add("rows_read", len(data))
        return GetKeyValuesReply(data=data, more=more)
