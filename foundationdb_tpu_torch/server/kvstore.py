"""Durable ordered key-value engine: log-structured merge over the sim disk.

Port of ``foundationdb_tpu/server/kvstore.py``.

The "ssd-class" IKeyValueStore the round-3 verdict called for (the role of
the reference's patched-sqlite btree engine, fdbserver/KeyValueStoreSQLite
.actor.cpp + IKeyValueStore.h:30-99) — own design: an LSM tree rather than
a B-tree, because the sim disk's fault model (torn un-synced writes,
AsyncFileNonDurable semantics) rewards append-only structures with
checksummed framing, and the write path of a storage server is
sequential-batch shaped anyway.

Structure on disk (all under a name prefix):
  <name>.dq            WAL via DiskQueue (checksummed frames, torn-tail
                       recovery, alternating pop headers)
  <name>-<seq>.sst     immutable sorted runs: 4KB-target blocks of wire-
                       encoded entries, a block index, range tombstones,
                       and a checksummed footer; always fully synced
                       BEFORE the manifest references them
  <name>.manifest      wire dict {runs: [...], seq}: written to a temp
                       file, synced, renamed (atomic install)

Write path: set/clear buffer into the memtable; commit() appends one WAL
frame and fsyncs — that is the durability point. When the memtable exceeds
flush_bytes, commit() also flushes it to a new run and truncates the WAL.
When runs pile past max_runs, a full merge compacts them to one (newest
precedence, tombstones dropped).

Read path: memtable -> runs newest-to-oldest, block reads on demand through
the per-run index with a small LRU block cache — the dataset does NOT live
in process memory; RAM holds the memtable, indexes, and the cache only.

Mutation precedence inside the memtable is tracked with sequence numbers;
a flush materializes point entries post-tombstone, so within a run a point
entry always wins and the run's range tombstones mask only older levels.
"""
from __future__ import annotations

import struct
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core import buggify, wire
from ..sim.actors import AsyncMutex
from ..sim.disk import SimDisk
from .disk_queue import DiskQueue

Key = bytes
Value = bytes

_FOOT = struct.Struct("<II")      # footer length, crc32


def _lookup(mem: Dict[Key, Tuple[int, Optional[Value]]],
            tombs: List[Tuple[int, Key, Key]],
            key: Key) -> Tuple[bool, Optional[Value]]:
    """Memtable precedence rule, shared by point gets (live state) and
    range reads (their snapshot): a point entry wins iff its seq is newer
    than every covering range tombstone."""
    e = mem.get(key)
    tomb_seq = max((s for s, b, x in tombs if b <= key < x), default=-1)
    if e is not None and e[0] > tomb_seq:
        return True, e[1]
    if tomb_seq >= 0:
        return True, None
    return False, None


class _Run:
    """One immutable sorted run: lazy block reads through the index."""

    def __init__(self, disk: SimDisk, name: str, index, tombs, cache, cache_cap):
        self.disk = disk
        self.name = name
        #: [(first_key, offset, length)] per block, ascending
        self.index = index
        #: [(begin, end)] range tombstones masking OLDER levels
        self.tombs = tombs
        self._cache = cache
        self._cache_cap = cache_cap

    @classmethod
    async def open(cls, disk: SimDisk, name: str, cache, cache_cap) -> "_Run":
        f = disk.open(name, create=False)
        size = f.size()
        raw = await f.read(size - _FOOT.size, _FOOT.size)
        flen, crc = _FOOT.unpack(raw)
        foot = await f.read(size - _FOOT.size - flen, flen)
        if zlib.crc32(foot) != crc:
            raise IOError(f"corrupt run footer: {name}")
        meta = wire.loads(foot)
        return cls(disk, name, meta["index"], meta["tombs"], cache, cache_cap)

    def covers_tomb(self, key: Key) -> bool:
        return any(b <= key < e for b, e in self.tombs)

    def _block_of(self, key: Key) -> int:
        """Index of the last block whose first_key <= key (-1: before all)."""
        lo, hi = -1, len(self.index) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.index[mid][0] <= key:
                lo = mid
            else:
                hi = mid - 1
        return lo

    async def _block(self, i: int) -> List[Tuple[Key, Optional[Value]]]:
        ck = (self.name, i)
        hit = self._cache.get(ck)
        if hit is not None:
            self._cache.move_to_end(ck)
            return hit
        _, off, length = self.index[i]
        f = self.disk.open(self.name, create=False)
        raw = await f.read(off, length)
        entries = wire.loads(raw)
        self._cache[ck] = entries
        while len(self._cache) > self._cache_cap:
            self._cache.popitem(last=False)
        return entries

    async def get(self, key: Key) -> Tuple[bool, Optional[Value]]:
        """(found, value|None-tombstone). found=False: key absent from this
        run's points (range tombstones are the caller's concern)."""
        i = self._block_of(key)
        if i < 0:
            return False, None
        entries = await self._block(i)
        lo, hi = 0, len(entries)
        while lo < hi:
            mid = (lo + hi) // 2
            if entries[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(entries) and entries[lo][0] == key:
            return True, entries[lo][1]
        return False, None

    async def iter_from(self, key: Key, reverse: bool = False):
        """Async generator of (k, v|None) from `key` (inclusive forward,
        <= key backward for reverse)."""
        nb = len(self.index)
        if not reverse:
            i = max(self._block_of(key), 0)
            while i < nb:
                for k, v in await self._block(i):
                    if k >= key:
                        yield k, v
                i += 1
        else:
            i = self._block_of(key)
            if i < 0:
                return
            while i >= 0:
                for k, v in reversed(await self._block(i)):
                    if k <= key:
                        yield k, v
                i -= 1


class SSTableStore:
    FLUSH_BYTES = 1 << 16
    MAX_RUNS = 6
    BLOCK_BYTES = 1 << 12
    CACHE_BLOCKS = 64

    def __init__(self, disk: SimDisk, name: str):
        self.disk = disk
        self.name = name
        self.wal = DiskQueue(disk, name)
        #: key -> (seq, value|None); range tombstones [(seq, begin, end)]
        self._mem: Dict[Key, Tuple[int, Optional[Value]]] = {}
        self._mem_tombs: List[Tuple[int, Key, Key]] = []
        self._mem_bytes = 0
        self._seq = 0
        self._run_seq = 0
        self._runs: List[_Run] = []          # newest first
        self._pending: List[Tuple] = []      # ops since last commit
        self._cache: OrderedDict = OrderedDict()
        #: readers mid-await: compaction must not delete run files under
        #: them (epoch-style reclamation — files die when the last reader
        #: that could still hold their _Run finishes)
        self._active_reads = 0
        self._defer_delete: List[str] = []
        #: serializes commit(): two concurrent committers (storage
        #: durability cycle vs extend_shard page commits, tlog spill vs
        #: pop clears) would otherwise interleave at the WAL-push await —
        #: one clearing _pending ops the other never logged — or race a
        #: _flush into the middle of a _compact's run-list rebuild
        self._commit_mutex = AsyncMutex()
        #: the background compaction, if one is running (commit() spawns)
        self._compact_task = None
        #: single-flight for the merge itself: a direct maintenance
        #: _compact() call must never overlap the background one (both
        #: snapshot the run list and reclaim files)
        self._compact_mutex = AsyncMutex()
        #: high-water mark of items the streaming merge buffered at once
        #: (heads + the current block) — the bounded-memory contract; tests
        #: assert it never approaches the dataset size
        self.compact_peak_items = 0

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    async def open(cls, disk: SimDisk, name: str) -> "SSTableStore":
        st = cls(disk, name)
        man = f"{name}.manifest"
        run_names: List[str] = []
        if disk.exists(man):
            f = disk.open(man)
            try:
                meta = wire.loads(await f.read(0, f.size()))
                run_names = meta["runs"]
                st._run_seq = meta["seq"]
            except Exception:
                run_names = []      # torn manifest: fresh store (pre-install)
        for rn in run_names:
            st._runs.append(await _Run.open(disk, rn, st._cache, cls.CACHE_BLOCKS))
        # Orphaned runs (crash between run sync and manifest install): GC.
        keep = set(run_names)
        for fname in disk.list(f"{name}-"):
            if fname.endswith(".sst") and fname not in keep:
                disk.delete(fname)
        for _, payload in await st.wal.recover():
            try:
                ops = wire.loads(payload)
            except Exception:
                break
            st._apply_ops(ops)
        st._pending = []
        return st

    def _apply_ops(self, ops) -> None:
        for op in ops:
            if op[0] == 0:
                self._mem_set(op[1], op[2])
            else:
                self._mem_clear(op[1], op[2])

    # -- write path ----------------------------------------------------------
    def _mem_set(self, key: Key, value: Optional[Value]) -> None:
        self._seq += 1
        self._mem[key] = (self._seq, value)
        self._mem_bytes += len(key) + (len(value) if value else 0) + 16

    def _mem_clear(self, begin: Key, end: Key) -> None:
        self._seq += 1
        self._mem_tombs.append((self._seq, begin, end))
        for k in [k for k in self._mem if begin <= k < end]:
            self._mem[k] = (self._seq, None)
        self._mem_bytes += len(begin) + len(end) + 16

    def set(self, key: Key, value: Value) -> None:
        self._pending.append((0, key, value))
        self._mem_set(key, value)

    def clear_range(self, begin: Key, end: Key) -> None:
        self._pending.append((1, begin, end))
        self._mem_clear(begin, end)

    async def commit(self) -> None:
        """Durability point: WAL frame + fsync; flush as needed
        (IKeyValueStore::commit). Serialized: ops staged after this
        committer's WAL snapshot ride the NEXT commit (and its fsync ack),
        never a half-logged state. Compaction runs in the BACKGROUND — the
        commit path never waits for a merge (the reference's btree spreads
        its page writes the same way)."""
        async with self._commit_mutex:
            if self._pending:
                ops, self._pending = self._pending, []
                if buggify.buggify():
                    # slow WAL append: widens the un-fsynced window a crash
                    # tears through
                    from ..sim.loop import TaskPriority, delay
                    await delay(0.01, TaskPriority.DEFAULT_DELAY)
                await self.wal.push(wire.dumps(ops))
            await self.wal.commit()
            flush_at = 256 if buggify.buggify() else self.FLUSH_BYTES
            if self._mem_bytes >= flush_at:
                await self._flush()
        max_runs = 1 if buggify.buggify() else self.MAX_RUNS
        if len(self._runs) > max_runs and self._compact_task is None:
            from ..sim.loop import TaskPriority, spawn

            t = spawn(self._compact_bg(), TaskPriority.LOW,
                      name=f"compact:{self.name}")
            self._compact_task = t

            def done(_f) -> None:
                self._compact_task = None

            t.on_ready(done)

    async def _write_run(self, entries, tombs) -> str:
        """entries: sorted [(k, v|None)]; returns the synced file name.
        One encoder for the run format: delegates to the streaming writer
        (which compaction also uses)."""
        async def gen():
            for e in entries:
                yield e
        return await self._write_run_stream(gen(), tombs)

    async def _install_manifest(self, run_names: List[str]) -> None:
        tmp = f"{self.name}.manifest.tmp"
        f = self.disk.open(tmp)
        await f.truncate(0)
        await f.write(0, wire.dumps({"runs": run_names, "seq": self._run_seq}))
        await f.sync()
        self.disk.rename(tmp, f"{self.name}.manifest")

    async def _flush(self) -> None:
        if not self._mem and not self._mem_tombs:
            return
        entries = sorted((k, v) for k, (_s, v) in self._mem.items())
        tombs = [(b, e) for _s, b, e in self._mem_tombs]
        rn = await self._write_run(entries, tombs)
        run = await _Run.open(self.disk, rn, self._cache, self.CACHE_BLOCKS)
        self._runs.insert(0, run)
        await self._install_manifest([r.name for r in self._runs])
        self._mem.clear()
        self._mem_tombs.clear()
        self._mem_bytes = 0
        if buggify.buggify():
            # crash window: run installed in the manifest but the WAL not
            # yet truncated — recovery must tolerate re-applying covered ops
            from ..sim.loop import TaskPriority, delay
            await delay(0.02, TaskPriority.DEFAULT_DELAY)
        # WAL content is fully covered by the installed run.
        await self.wal.pop_to(self.wal.end_offset)

    async def _write_run_stream(self, entries, tombs) -> str:
        """Write one sorted run from an ASYNC ITERATOR of (k, v) entries,
        block by block — the one and only encoder of the on-disk run
        format (a second inline copy would silently diverge from
        _Run.open's expectations). Returns the synced file name."""
        self._run_seq += 1
        rn = f"{self.name}-{self._run_seq}.sst"
        f = self.disk.open(rn)
        await f.truncate(0)
        index = []
        off = 0
        blk: List[Tuple[Key, Value]] = []
        bbytes = 0
        n_entries = 0

        async def flush_blk():
            nonlocal off, blk, bbytes
            raw = wire.dumps(blk)
            await f.write(off, raw)
            index.append((blk[0][0], off, len(raw)))
            off += len(raw)
            blk, bbytes = [], 0

        async for k, v in entries:
            blk.append((k, v))
            n_entries += 1
            bbytes += len(k) + len(v or b"") + 8
            self.compact_peak_items = max(self.compact_peak_items, len(blk))
            if bbytes >= self.BLOCK_BYTES:
                await flush_blk()
                if buggify.buggify():
                    # mid-write crash window: the half-written run is an
                    # orphan reopen GCs; the manifest still names the OLD
                    # runs
                    from ..sim.loop import TaskPriority, delay
                    await delay(0.02, TaskPriority.DEFAULT_DELAY)
        if blk:
            await flush_blk()
        foot = wire.dumps({"index": index, "tombs": tombs, "n": n_entries})
        await f.write(off, foot + _FOOT.pack(len(foot), zlib.crc32(foot)))
        await f.sync()
        return rn

    async def _merged_entries(self, snapshot):
        """Streaming k-way merge over `snapshot` runs (newest first):
        newest precedence, tombstones of newer runs mask older entries,
        resolved deletions drop out. Peak memory: one head per run."""
        iters = [r.iter_from(b"") for r in snapshot]
        heads: List[Optional[Tuple[Key, Optional[Value]]]] = []
        for it in iters:
            try:
                heads.append(await anext(it))
            except StopAsyncIteration:
                heads.append(None)
        while True:
            pick: Optional[Key] = None
            for h in heads:
                if h is not None and (pick is None or h[0] < pick):
                    pick = h[0]
            if pick is None:
                return
            val: Optional[Value] = None
            taken = None
            for i, h in enumerate(heads):
                if h is not None and h[0] == pick:
                    if taken is None:
                        taken = i
                        val = h[1]
                    try:
                        heads[i] = await anext(iters[i])
                    except StopAsyncIteration:
                        heads[i] = None
            if taken is not None and any(
                snapshot[up].covers_tomb(pick) for up in range(taken)
            ):
                val = None
            if val is not None:
                yield pick, val

    async def _compact_bg(self) -> None:
        """Background full compaction of a SNAPSHOT of the current runs:
        streaming k-way merge (newest precedence, tombstones resolved and
        dropped), blocks written incrementally — peak memory is one block
        plus one head per run, NEVER the dataset ("the dataset does not
        live in process memory" holds through its own maintenance).
        Commits keep flushing new runs meanwhile; the install swaps only
        the snapshotted suffix of the run list. Single-flight under the
        compact mutex (a direct _compact() call serializes behind us)."""
        async with self._compact_mutex:
            await self._compact_locked()

    async def _compact_locked(self) -> None:
        snapshot = list(self._runs)
        if len(snapshot) < 2:
            return
        rn = await self._write_run_stream(self._merged_entries(snapshot), [])
        run = await _Run.open(self.disk, rn, self._cache, self.CACHE_BLOCKS)
        if buggify.buggify():
            # crash window: merged run durable but manifest not installed —
            # reopen must GC the orphan and serve the OLD manifest's runs
            from ..sim.loop import TaskPriority, delay
            await delay(0.02, TaskPriority.DEFAULT_DELAY)
        # swap ONLY the snapshotted suffix: runs flushed during the merge
        # stay in front (they are newer than the merged result). The
        # install shares the commit mutex so a concurrent flush's manifest
        # write cannot interleave with ours on the tmp file.
        async with self._commit_mutex:
            keep = self._runs[: len(self._runs) - len(snapshot)]
            assert self._runs[len(self._runs) - len(snapshot):] == snapshot
            old = [r.name for r in snapshot]
            self._runs = keep + [run]
            await self._install_manifest([r.name for r in self._runs])
        for name in old:
            for ck in [c for c in self._cache if c[0] == name]:
                del self._cache[ck]
        self._reclaim(old)

    async def _compact(self) -> None:
        """Synchronous full merge (tests and maintenance entry): the same
        streaming path, serialized behind any background merge."""
        await self._compact_bg()

    def _reclaim(self, names: List[str]) -> None:
        """Delete run files now, or park them until in-flight reads drain
        (a reader's _Run would otherwise hit file_not_found mid-block)."""
        if self._active_reads > 0:
            self._defer_delete.extend(names)
        else:
            for name in names:
                self.disk.delete(name)

    def _read_done(self) -> None:
        self._active_reads -= 1
        if self._active_reads == 0 and self._defer_delete:
            names, self._defer_delete = self._defer_delete, []
            for name in names:
                self.disk.delete(name)

    # -- read path -----------------------------------------------------------
    def _mem_lookup(self, key: Key) -> Tuple[bool, Optional[Value]]:
        return _lookup(self._mem, self._mem_tombs, key)

    async def get(self, key: Key) -> Optional[Value]:
        found, v = self._mem_lookup(key)
        if found:
            return v
        if buggify.buggify():
            # slow cold read: stretches the window a concurrent
            # flush/compaction can interleave into
            from ..sim.loop import TaskPriority, delay
            await delay(0.01, TaskPriority.DEFAULT_DELAY)
        runs = list(self._runs)     # snapshot: a flush/compact mid-read
        self._active_reads += 1     # must not shift or delete our levels
        try:
            for run in runs:
                found, v = await run.get(key)
                if found:
                    return v
                if run.covers_tomb(key):
                    return None
            return None
        finally:
            self._read_done()

    async def get_range(self, begin: Key, end: Key, limit: int,
                        reverse: bool = False) -> Tuple[List[Tuple[Key, Value]], bool]:
        """Merged live entries in [begin, end); (items, more). The memtable
        and run list are SNAPSHOTTED up front: a commit/flush/compact
        interleaving with this read's block awaits must not clear _mem
        under the lazy cursor or renumber the precedence levels."""
        out: List[Tuple[Key, Value]] = []
        # Per-level cursors: (next entry, level, iterator). Memtable is
        # level -1 (highest precedence).
        mem_snap = {k: e for k, e in self._mem.items() if begin <= k < end}
        mem_tombs = list(self._mem_tombs)
        runs = list(self._runs)
        mem_keys = sorted(mem_snap)
        if reverse:
            mem_keys.reverse()

        async def mem_iter():
            for k in mem_keys:
                yield k, mem_snap[k][1]

        def mem_lookup(key: Key) -> Tuple[bool, Optional[Value]]:
            return _lookup(mem_snap, mem_tombs, key)

        def masked(key: Key, level: int) -> bool:
            # masked by a range tombstone strictly newer than `level`
            # (level -1 = memtable; runs are levels 0..). Memtable point
            # entries override mem tombs via seq; for runs the memtable
            # tomb always wins (it is newer than every run).
            if level >= 0 and any(b <= key < e for _s, b, e in mem_tombs):
                return True
            for up in range(max(level, 0)):
                if runs[up].covers_tomb(key):
                    return True
            return False

        iters = [(-1, mem_iter())]
        for lvl, run in enumerate(runs):
            if reverse:
                it = run.iter_from(end, reverse=True)
            else:
                it = run.iter_from(begin)
            iters.append((lvl, it))

        self._active_reads += 1
        try:
            heads: List[Optional[Tuple[Key, Optional[Value]]]] = []
            live: List = []
            for lvl, it in iters:
                try:
                    nxt = await anext(it)
                    if reverse and lvl >= 0 and nxt[0] >= end:
                        while nxt[0] >= end:
                            nxt = await anext(it)
                except StopAsyncIteration:
                    nxt = None
                heads.append(nxt)
                live.append(it)

            def better(a: Key, b: Key) -> bool:
                return a > b if reverse else a < b

            while len(out) < limit:
                # pick frontier key across levels
                pick: Optional[Key] = None
                for h in heads:
                    if h is not None and (not reverse and h[0] >= end):
                        continue
                    if h is not None and (pick is None or better(h[0], pick)):
                        pick = h[0]
                if pick is None or (not reverse and pick >= end) or (reverse and pick < begin):
                    return out, False
                # resolve precedence: lowest level index with this key wins
                val: Optional[Value] = None
                taken_level = None
                for idx, h in enumerate(heads):
                    if h is not None and h[0] == pick:
                        if taken_level is None:
                            taken_level = idx - 1   # level: -1 memtable
                            val = h[1]
                        try:
                            heads[idx] = await anext(live[idx])
                        except StopAsyncIteration:
                            heads[idx] = None
                if taken_level is not None and taken_level >= 0 and masked(pick, taken_level):
                    val = None
                elif taken_level == -1:
                    # memtable entry: seq already resolved vs mem tombs
                    found, val = mem_lookup(pick)
                if val is not None and (begin <= pick < end):
                    out.append((pick, val))
            return out, True
        finally:
            self._read_done()

    # -- maintenance ---------------------------------------------------------
    def destroy(self) -> None:
        """Delete every on-disk artifact (IKeyValueStore::dispose)."""
        if self._compact_task is not None:
            self._compact_task.cancel()
            self._compact_task = None
        for rn in [r.name for r in self._runs] + self._defer_delete:
            self.disk.delete(rn)
        self._defer_delete = []
        self.disk.delete(f"{self.name}.manifest")
        self.disk.delete(f"{self.name}.manifest.tmp")
        self.disk.delete(f"{self.name}.dq")
        self.disk.delete(f"{self.name}.dq.tmp")
