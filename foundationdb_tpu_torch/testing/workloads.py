"""The core workload set (reference: fdbserver/workloads/, 84 files).

Port of ``foundationdb_tpu/testing/workloads.py``.

Round-1 inventory, mirroring the reference's invariant checkers most
relevant to the resolver north star (SURVEY.md §4.2):

  CycleWorkload           Cycle.actor.cpp — ring permutation invariant
  IncrementWorkload       Increment.actor.cpp — read-modify-write counters
  AtomicOpsWorkload       AtomicOps.actor.cpp — commutative ops, exact totals
  WriteDuringReadWorkload WriteDuringRead.actor.cpp — randomized op streams
                          vs an in-transaction RYW model
  ConflictRangeWorkload   ConflictRange.actor.cpp — randomized range reads
                          vs a version-replayed model under deliberate
                          conflicting writers (external consistency check)
  RandomReadWriteWorkload ReadWrite.actor.cpp — the 90/10 metric workload
  RandomCloggingWorkload  RandomClogging.actor.cpp — anti-quiescence network
                          fault injector

BackupCorrectnessWorkload is not ported yet: it needs backup/ and the
bindings it imports.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from ..core import error
from ..core.types import MutationType
from ..client.database import Database
from ..sim.loop import delay
from .workload import TestWorkload

# ---------------------------------------------------------------------------


class CycleWorkload(TestWorkload):
    """A ring permutation over `nodes` keys; each transaction rotates three
    links; the ring must stay a single cycle (Cycle.actor.cpp cycleCheck)."""

    name = "Cycle"

    @property
    def n(self) -> int:
        return int(self.ctx.options.get("nodes", 12))

    def key(self, i: int) -> bytes:
        return b"cycle/%04d" % i

    async def setup(self, db: Database) -> None:
        tr = db.create_transaction()
        for i in range(self.n):
            tr.set(self.key(i), b"%04d" % ((i + 1) % self.n))
        await tr.commit()

    async def start(self, db: Database) -> None:
        count = int(self.ctx.options.get("transactions", 20))
        # Pace transactions so the run overlaps with injected faults
        # (reference: transactionsPerSecond paces Cycle.actor.cpp; without
        # pacing the workload finishes before attrition ever fires).
        think = float(self.ctx.options.get("think_time", 0.0))
        for _ in range(count):
            async def body(tr):
                r = self.ctx.rng.random_int(0, self.n)
                p1 = int(await tr.get(self.key(r)))
                p2 = int(await tr.get(self.key(p1)))
                p3 = int(await tr.get(self.key(p2)))
                tr.set(self.key(r), b"%04d" % p2)
                tr.set(self.key(p1), b"%04d" % p3)
                tr.set(self.key(p2), b"%04d" % p1)

            await db.run(body)
            self.ctx.count("cycle_txns")
            if think > 0:
                await delay(think * self.ctx.rng.random01() * 2)

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"cycle/", b"cycle0")

        got = await db.run(read_all)
        if len(got) != self.n:
            return False
        nxt = {int(k[-4:]): int(v) for k, v in got}
        seen, at = set(), 0
        for _ in range(self.n):
            if at in seen:
                return False
            seen.add(at)
            at = nxt[at]
        return at == 0


class IncrementWorkload(TestWorkload):
    """Read-modify-write counters under contention (Increment.actor.cpp):
    the final sum must equal the number of committed increments."""

    name = "Increment"

    async def start(self, db: Database) -> None:
        count = int(self.ctx.options.get("transactions", 15))
        keys = int(self.ctx.options.get("keys", 4))
        done = 0
        for _ in range(count):
            async def body(tr):
                k = b"incr/%02d" % self.ctx.rng.random_int(0, keys)
                cur = await tr.get(k)
                n = int.from_bytes(cur or b"\0\0\0\0", "big")
                tr.set(k, (n + 1).to_bytes(4, "big"))

            await db.run(body)
            done += 1
        self.ctx.count("increments", done)

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"incr/", b"incr0")

        got = await db.run(read_all)
        total = sum(int.from_bytes(v, "big") for _, v in got)
        return total == int(self.ctx.shared.get("increments", 0))


class AtomicOpsWorkload(TestWorkload):
    """Blind atomic ADDs never conflict; totals must be exact
    (AtomicOps.actor.cpp)."""

    name = "AtomicOps"

    async def start(self, db: Database) -> None:
        count = int(self.ctx.options.get("transactions", 20))
        keys = int(self.ctx.options.get("keys", 3))
        added = 0
        for _ in range(count):
            tr = db.create_transaction()
            k = b"atomic/%02d" % self.ctx.rng.random_int(0, keys)
            amount = self.ctx.rng.random_int(1, 10)
            tr.atomic_op(k, amount.to_bytes(8, "little"), MutationType.ADD_VALUE)
            await tr.commit()
            added += amount
        self.ctx.count("atomic_added", added)

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"atomic/", b"atomic0")

        got = await db.run(read_all)
        total = sum(int.from_bytes(v, "little") for _, v in got)
        return total == int(self.ctx.shared.get("atomic_added", 0))


# ---------------------------------------------------------------------------


class MemoryKeyValueStore:
    """In-memory model store (reference:
    fdbserver/workloads/MemoryKeyValueStore.cpp)."""

    def __init__(self) -> None:
        self._d: Dict[bytes, bytes] = {}

    def set(self, k: bytes, v: bytes) -> None:
        self._d[k] = v

    def clear_range(self, b: bytes, e: bytes) -> None:
        for k in [k for k in self._d if b <= k < e]:
            del self._d[k]

    def get(self, k: bytes) -> Optional[bytes]:
        return self._d.get(k)

    def get_range(self, b: bytes, e: bytes) -> List[Tuple[bytes, bytes]]:
        return sorted((k, v) for k, v in self._d.items() if b <= k < e)

    def apply_mutation(self, m) -> None:
        from ..core.types import SINGLE_KEY_MUTATIONS, apply_atomic_op

        if m.type == MutationType.SET_VALUE:
            self.set(m.param1, m.param2)
        elif m.type == MutationType.CLEAR_RANGE:
            self.clear_range(m.param1, m.param2)
        elif m.type in SINGLE_KEY_MUTATIONS:
            self.set(m.param1, apply_atomic_op(m.type, self.get(m.param1), m.param2))


class WriteDuringReadWorkload(TestWorkload):
    """Randomized op streams inside one transaction: every read must see the
    RYW overlay exactly as an in-memory model predicts, and the committed
    state must match the model (WriteDuringRead.actor.cpp strategy)."""

    name = "WriteDuringRead"

    @property
    def _prefix(self) -> bytes:
        return b"wdr%d/" % self.ctx.client_id

    def _rand_key(self) -> bytes:
        return self._prefix + b"%02d" % self.ctx.rng.random_int(0, 12)

    async def start(self, db: Database) -> None:
        rng = self.ctx.rng
        committed = MemoryKeyValueStore()
        rounds = int(self.ctx.options.get("rounds", 15))
        pre = self._prefix
        for _ in range(rounds):
            tr = db.create_transaction()
            model = MemoryKeyValueStore()
            for k, v in committed.get_range(pre, pre + b"\xff"):
                model.set(k, v)
            ops = rng.random_int(3, 12)
            for _ in range(ops):
                o = rng.random01()
                k = self._rand_key()
                if o < 0.25:
                    v = b"v%d" % rng.random_int(0, 1000)
                    tr.set(k, v)
                    model.set(k, v)
                elif o < 0.4:
                    k2 = self._rand_key()
                    b, e = min(k, k2), max(k, k2) + b"\x00"
                    tr.clear_range(b, e)
                    model.clear_range(b, e)
                elif o < 0.55:
                    amt = rng.random_int(1, 100).to_bytes(8, "little")
                    tr.atomic_op(k, amt, MutationType.ADD_VALUE)
                    model.set(k, _le_add(model.get(k), amt))
                elif o < 0.8:
                    got = await tr.get(k)
                    assert got == model.get(k), f"RYW get mismatch at {k}: {got} != {model.get(k)}"
                else:
                    k2 = self._rand_key()
                    b, e = min(k, k2), max(k, k2) + b"\x00"
                    got = await tr.get_range(b, e)
                    want = model.get_range(b, e)
                    assert got == want, f"RYW range mismatch: {got} != {want}"
            await tr.commit()
            committed = model
            self.ctx.count("wdr_rounds")
        self._final = committed

    async def check(self, db: Database) -> bool:
        pre = self._prefix

        async def read_all(tr):
            return await tr.get_range(pre, pre + b"\xff")

        got = await db.run(read_all)
        return got == self._final.get_range(pre, pre + b"\xff")


def _le_add(old: Optional[bytes], param: bytes) -> bytes:
    from ..core.types import apply_atomic_op

    return apply_atomic_op(MutationType.ADD_VALUE, old, param)


class ConflictRangeWorkload(TestWorkload):
    """External-consistency check under deliberate conflicts
    (ConflictRange.actor.cpp re-thought for the version-replay model):

    Writer clients commit random sets/clears recording (commit_version,
    mutations); reader clients record (read_version, range, result). At
    check time, committed writes are replayed in version order; every
    read's result must equal the model at its read version."""

    name = "ConflictRange"
    PREFIX = b"cr/"

    def _rand_key(self) -> bytes:
        return self.PREFIX + b"%02d" % self.ctx.rng.random_int(0, 16)

    async def start(self, db: Database) -> None:
        rng = self.ctx.rng
        self.writes: List[Tuple[int, List]] = []
        self.reads: List[Tuple[int, bytes, bytes, List]] = []
        rounds = int(self.ctx.options.get("rounds", 20))
        for _ in range(rounds):
            if self.ctx.client_id % 2 == 0:
                # writer: random small txn of sets/clears
                tr = db.create_transaction()
                for _ in range(rng.random_int(1, 4)):
                    if rng.random01() < 0.75:
                        tr.set(self._rand_key(), b"w%d" % rng.random_int(0, 10_000))
                    else:
                        a, b = self._rand_key(), self._rand_key()
                        tr.clear_range(min(a, b), max(a, b) + b"\x00")
                muts = list(tr.mutations)
                try:
                    v = await tr.commit()
                    self.writes.append((v, tr.committed_batch_index, muts))
                except error.FDBError as e:
                    if not e.is_retryable():
                        raise
            else:
                # reader: snapshot of a random subrange at its read version
                tr = db.create_transaction()
                a, b = self._rand_key(), self._rand_key()
                lo, hi = min(a, b), max(a, b) + b"\x00"
                got = await tr.get_range(lo, hi, snapshot=True)
                rv = await tr.get_read_version()
                self.reads.append((rv, lo, hi, got))
            await delay(0.001 * rng.random01())
        # Shared registry so client 0's check sees every client's log.
        self.ctx.shared.setdefault("writes", []).extend(self.writes)
        self.ctx.shared.setdefault("reads", []).extend(self.reads)

    async def check(self, db: Database) -> bool:
        writes = self.ctx.shared.get("writes", [])
        reads = self.ctx.shared.get("reads", [])
        model = MemoryKeyValueStore()
        # Commits sharing a version apply in txn_batch_index order; reads at
        # version rv see every commit with version <= rv (kind 1 sorts last).
        events: List[Tuple[int, int, int, object]] = []
        for v, bi, muts in writes:
            events.append((v, 0, bi, muts))
        for rv, lo, hi, got in reads:
            events.append((rv, 1, 0, (lo, hi, got)))
        events.sort(key=lambda e: (e[0], e[1], e[2]))
        for v, kind, _bi, payload in events:
            if kind == 0:
                for m in payload:
                    model.apply_mutation(m)
            else:
                lo, hi, got = payload
                want = model.get_range(lo, hi)
                if got != want:
                    return False
        # Final DB state must match the fully-replayed model.
        tr = db.create_transaction()
        got = await tr.get_range(self.PREFIX, self.PREFIX + b"\xff")
        return got == model.get_range(self.PREFIX, self.PREFIX + b"\xff")


class RandomReadWriteWorkload(TestWorkload):
    """The 90/10 metric workload (ReadWrite.actor.cpp, tests/RandomReadWrite.txt)."""

    name = "RandomReadWrite"

    async def start(self, db: Database) -> None:
        rng = self.ctx.rng
        txns = int(self.ctx.options.get("transactions", 25))
        keys = int(self.ctx.options.get("keys", 64))
        read_frac = float(self.ctx.options.get("read_fraction", 0.9))
        ops_per_txn = int(self.ctx.options.get("ops_per_txn", 10))
        committed = conflicts = 0
        for _ in range(txns):
            tr = db.create_transaction()
            try:
                for _ in range(ops_per_txn):
                    # Zipf-ish: square the uniform draw to bias toward low keys
                    k = b"rw/%04d" % int(rng.random01() ** 2 * keys)
                    if rng.random01() < read_frac:
                        await tr.get(k)
                    else:
                        tr.set(k, b"x" * 16)
                await tr.commit()
                committed += 1
            except error.FDBError as e:
                if e.code == error.not_committed("").code:
                    conflicts += 1
                elif not e.is_retryable():
                    raise
        self.ctx.count("rw_committed", committed)
        self.ctx.count("rw_conflicts", conflicts)


class RandomCloggingWorkload(TestWorkload):
    """Anti-quiescence: randomly clog processes' links while others run
    (RandomClogging.actor.cpp via g_simulator.clogInterface)."""

    name = "RandomClogging"
    anti_quiescence = True

    async def start(self, db: Database) -> None:
        sim = self.ctx.cluster.sim
        rng = self.ctx.rng
        scale = float(self.ctx.options.get("scale", 0.05))
        while True:
            await delay(rng.random01() * 10 * scale)
            procs = list(sim.net.processes.values())
            victim = procs[rng.random_int(0, len(procs))]
            sim.clog_process(victim, rng.random01() * scale)


class MachineAttritionWorkload(TestWorkload):
    """Anti-quiescence: kill (and reboot) workers hosting transaction roles
    while the other workloads run — the reference's core correctness
    strategy (MachineAttrition.actor.cpp). Requires a DynamicCluster, whose
    recovery machinery the kills exercise; storage-hosting workers are
    spared until the durability round makes storage restartable."""

    name = "MachineAttrition"
    anti_quiescence = True

    TXN_TOKENS = ("tlog.commit", "resolver.resolve", "proxy.commit",
                  "master.getCommitVersion")

    def _safe_victims(self, cluster):
        """Kill-safety analysis (reference: ISimulator::canKillProcesses,
        simulator.h:155). With durable tlogs/storage (DiskQueue + snapshot
        WAL) and REBOOT-only kills, every role host recovers from its own
        disk, so any worker hosting a role is a safe victim — including all
        tlog replicas at once (recovery waits for one to reboot and
        restore). Storage kills are gated by the spare_storage option for
        specs that want to isolate transaction-subsystem churn."""
        spare_storage = bool(self.ctx.options.get("spare_storage", False))
        out = []
        for p in cluster.worker_procs:
            if not p.alive:
                continue
            hosts_storage = any(t.startswith("storage.") for t in p.handlers)
            if spare_storage and hosts_storage:
                continue
            if hosts_storage or any(t.startswith(self.TXN_TOKENS) for t in p.handlers):
                out.append(p)
        return out

    async def start(self, db: Database) -> None:
        from ..sim.simulator import KillType

        # One killer only (reference MachineAttrition gates on clientId 0):
        # concurrent independent killers defeat the safety analysis.
        if self.ctx.client_id != 0:
            return
        cluster = self.ctx.cluster
        sim = cluster.sim
        rng = self.ctx.rng
        interval = float(self.ctx.options.get("interval", 8.0))
        await delay(float(self.ctx.options.get("delay_before", 4.0)))
        while True:
            victims = self._safe_victims(cluster)
            if victims:
                victim = victims[rng.random_int(0, len(victims))]
                self.ctx.count("kills")
                sim.kill_process(victim, KillType.REBOOT)
            await delay(interval)


class WatchesWorkload(TestWorkload):
    """Watch/trigger ping-pong (Watches.actor.cpp): client pairs bounce a
    counter; every bounce is driven by a watch firing with the new value."""

    name = "Watches"

    async def start(self, db: Database) -> None:
        rounds = int(self.ctx.options.get("rounds", 6))
        me = self.ctx.client_id
        peer = (me + 1) % self.ctx.client_count
        key_me = b"watch/%02d" % me
        key_peer = b"watch/%02d" % peer

        async def write_my(tr, n):
            tr.set(key_me, b"%06d" % n)

        async def read_peer(tr):
            return await tr.get(key_peer, snapshot=True), tr.read_version

        async def wait_peer_at_least(n):
            """Race-free wait: watch registered against the value THIS read
            observed (the reference registers watches inside the reading
            transaction for the same atomicity)."""
            while True:
                cur, rv = await db.run(read_peer)
                if cur is not None and int(cur) >= n:
                    return cur
                await db.create_transaction().watch(
                    key_peer, expected=cur, expected_version=rv)

        # client 0 serves: write mine, wait for peer's echo via watch
        for n in range(rounds):
            if me == 0:
                await db.run(write_my, n)
                got = await wait_peer_at_least(n)
                if int(got) == n:
                    self.ctx.count("watch_bounces")
            else:
                if n > 0:
                    await wait_peer_at_least(n)
                await db.run(write_my, n)

    async def check(self, db: Database) -> bool:
        # liveness is the check: every round required a watch to fire
        return self.ctx.shared.get("watch_bounces", 0) >= 1


class SelectorCorrectnessWorkload(TestWorkload):
    """Key-selector resolution vs a host model (SelectorCorrectness
    .actor.cpp): random selectors over a known key set must resolve to the
    model's answer."""

    name = "SelectorCorrectness"

    async def setup(self, db: Database) -> None:
        async def w(tr):
            for i in range(20):
                tr.set(b"sel/%03d" % (i * 5), b"v")
        await db.run(w)

    async def start(self, db: Database) -> None:
        from ..client.database import KeySelector

        rng = self.ctx.rng
        keys = [b"sel/%03d" % (i * 5) for i in range(20)]
        checks = int(self.ctx.options.get("checks", 30))

        def model(anchor, or_equal, offset):
            """Resolution index within this workload's key set; None when it
            would walk outside sel/ (other workloads' keys live there, so
            the database's answer is out of this model's scope)."""
            i0 = (bisect.bisect_right(keys, anchor) if or_equal
                  else bisect.bisect_left(keys, anchor))
            i = i0 + offset - 1
            if 0 <= i < len(keys):
                return keys[i]
            return None

        for _ in range(checks):
            anchor = b"sel/%03d" % rng.random_int(0, 100)
            or_equal = rng.coinflip()
            offset = rng.random_int(-3, 4)
            want = model(anchor, or_equal, offset)
            if want is None:
                continue
            sel = KeySelector(anchor, or_equal, offset)

            async def resolve(tr):
                return await tr.get_key(sel)

            got = await db.run(resolve)
            if got != want:
                self.ctx.count("selector_mismatches")
            self.ctx.count("selector_checks")

    async def check(self, db: Database) -> bool:
        return (self.ctx.shared.get("selector_mismatches", 0) == 0
                and self.ctx.shared.get("selector_checks", 0) > 0)


class VersionStampWorkload(TestWorkload):
    """Versionstamped keys/values (VersionStamp.actor.cpp): every committed
    stamp must equal the commit's (version, batch index), stamps must be
    unique and monotone in commit order, and stamped keys must land in the
    keyspace exactly where the stamp says."""

    name = "VersionStamp"

    async def start(self, db: Database) -> None:
        import struct

        rounds = int(self.ctx.options.get("rounds", 8))
        me = self.ctx.client_id
        committed: List[Tuple[int, bytes]] = []
        for n in range(rounds):
            tr = db.create_transaction()
            prefix = b"vsw/%02d/" % me
            raw_key = prefix + b"\x00" * 10 + struct.pack("<i", len(prefix))
            tr.atomic_op(raw_key, b"%04d" % n, MutationType.SET_VERSIONSTAMPED_KEY)
            raw_val = b"\x00" * 10 + b"|%02d|%04d" % (me, n) + struct.pack("<i", 0)
            tr.atomic_op(b"vsv/%02d" % me, raw_val, MutationType.SET_VERSIONSTAMPED_VALUE)
            try:
                v = await tr.commit()
            except error.FDBError as e:
                if e.is_retryable():
                    continue
                raise
            stamp = tr.get_versionstamp()
            assert int.from_bytes(stamp[:8], "big") == v
            committed.append((v, stamp))
            self.ctx.count("stamps")
        # monotone + unique within this client
        stamps = [s for _, s in committed]
        assert stamps == sorted(stamps) and len(set(stamps)) == len(stamps)
        self.ctx.shared.setdefault("by_client", {})[me] = committed

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"vsw/", b"vsw0"), await tr.get_range(b"vsv/", b"vsv0")

        keyed, valued = await db.run(read_all)
        by_client = self.ctx.shared.get("by_client", {})
        # every committed stamped KEY exists exactly where the stamp says
        expect_keys = set()
        for me, committed in by_client.items():
            for _v, stamp in committed:
                expect_keys.add(b"vsw/%02d/" % me + stamp)
        got_keys = {k for k, _ in keyed}
        if not expect_keys <= got_keys:
            return False
        # each client's stamped VALUE carries that client's newest stamp
        for me, committed in by_client.items():
            if not committed:
                continue
            newest = committed[-1][1]
            row = dict(valued).get(b"vsv/%02d" % me)
            if row is None or row[:10] != newest:
                return False
        return True


class ConsistencyCheckWorkload(TestWorkload):
    """Quiescent replica consistency check (ConsistencyCheck.actor.cpp,
    run by tester.actor.cpp:740 after most specs): at one read version,
    read every shard's full contents directly from EVERY replica of its
    team and require bit-identical results. Replicas that stay unreachable
    across retries are skipped (a killed-and-never-restored replica must
    not fail the check — that is the scenario replication exists for), but
    at least one replica per shard must serve."""

    name = "ConsistencyCheck"
    END = b"\xff\xff\xff"

    async def check(self, db: Database) -> bool:
        from ..server import storage as storage_mod
        from ..server.messages import GetKeyValuesRequest
        from ..sim.network import Endpoint
        from ..sim.loop import TaskPriority

        tr = db.create_transaction()
        while True:
            try:
                rv = await tr.get_read_version()
                locs = await db.get_locations(b"", self.END)
                break
            except error.FDBError as e:
                await tr.on_error(e)
                tr = db.create_transaction()

        _transport = {
            error.connection_failed("").code,
            error.request_maybe_delivered("").code,
            error.timed_out("").code,
        }

        async def read_replica(addr, rng):
            """Full clipped shard contents from one replica at rv. Returns
            None only for a replica that stays UNREACHABLE (transport
            errors) — a live replica that keeps erroring (future_version,
            wrong_shard: lagging or divergent state) must fail the check,
            not be skipped, or the workload would excuse exactly the bug
            class it exists to catch."""
            rows, cb, ce = [], rng.begin, min(rng.end, self.END)
            transport_errs = live_errs = 0
            while cb < ce:
                try:
                    reply = await db.net.request(
                        db.client_addr,
                        Endpoint(addr, storage_mod.GET_KEY_VALUES_TOKEN),
                        GetKeyValuesRequest(begin=cb, end=ce, version=rv,
                                            limit=10_000),
                        TaskPriority.DEFAULT_ENDPOINT, timeout=5.0,
                    )
                except error.FDBError as e:
                    if e.code in _transport:
                        transport_errs += 1
                        if transport_errs >= 10:
                            return None
                    else:
                        live_errs += 1
                        if live_errs >= 60:
                            self.ctx.count("replica_stuck_erroring")
                            return "stuck:%s" % e.name
                    await delay(0.5)
                    continue
                rows.extend(reply.data)
                if not reply.more or not reply.data:
                    break
                from ..core.types import key_after

                cb = key_after(reply.data[-1][0])
            return rows

        for rng, addrs in locs:
            views = []
            for addr in addrs:
                rows = await read_replica(addr, rng)
                if isinstance(rows, str):
                    return False  # live replica stuck erroring: never skip
                if rows is not None:
                    views.append((addr, rows))
            if not views:
                self.ctx.count("shards_with_no_replica")
                return False
            self.ctx.count("replicas_checked", len(views))
            baseline = views[0][1]
            for addr, rows in views[1:]:
                if rows != baseline:
                    self.ctx.count("replica_mismatches")
                    return False
        return True


class RandomMoveKeysWorkload(TestWorkload):
    """Move random shards to random spare workers while other workloads
    run (RandomMoveKeys.actor.cpp): the shard map is discovered through
    the `\\xff/keyServers/` system keyspace, and every move must leave the
    database consistent (the spec's other checkers + ConsistencyCheck
    prove it)."""

    name = "RandomMoveKeys"

    async def start(self, db: Database) -> None:
        from ..server import system_keys
        from ..server.masterserver import MOVE_SHARD_TOKEN, MoveShardRequest
        from ..sim.loop import TaskPriority
        from ..sim.network import Endpoint

        if self.ctx.client_id != 0:
            return
        cluster = self.ctx.cluster
        sim = cluster.sim
        rng = self.ctx.rng
        moves = int(self.ctx.options.get("moves", 2))
        interval = float(self.ctx.options.get("interval", 4.0))
        await delay(float(self.ctx.options.get("delay_before", 3.0)))
        for _ in range(moves):
            await delay(interval * (0.5 + rng.random01()))
            ep = None
            for p in cluster.worker_procs:
                for tok in p.handlers:
                    if tok.startswith(MOVE_SHARD_TOKEN):
                        ep = Endpoint(p.address, tok)
            if ep is None:
                continue
            # shard map + team sizes from the system keyspace
            async def read_meta(tr):
                return await tr.get_range(system_keys.KEY_SERVERS_PREFIX,
                                          system_keys.KEY_SERVERS_PREFIX + b"\xff")
            try:
                rows = await db.run(read_meta)
            except error.FDBError:
                continue
            if not rows:
                continue
            key, value = rows[rng.random_int(0, len(rows))]
            begin = system_keys.shard_begin_of(key)
            team, _extra = system_keys.decode_key_servers(value)
            storage_addrs = {
                p.address for p in cluster.worker_procs
                if any(t.startswith("storage.getValue") for t in p.handlers)
            }
            spare = [p.address for p in cluster.worker_procs
                     if p.alive and p.address not in storage_addrs]
            if len(spare) < len(team):
                continue
            dests = []
            pool = list(spare)
            for _i in range(len(team)):
                dests.append(pool.pop(rng.random_int(0, len(pool))))
            try:
                await sim.net.request(
                    db.client_addr, ep,
                    MoveShardRequest(begin=begin, dest_workers=dests),
                    TaskPriority.MOVE_KEYS, timeout=120.0,
                )
                self.ctx.count("moves")
            except error.FDBError:
                self.ctx.count("move_failures")


class FuzzApiCorrectnessWorkload(TestWorkload):
    """Randomized multi-transaction op streams vs the in-memory model
    (FuzzApiCorrectness.actor.cpp strategy). Each client owns a prefix.

    Unknown-result settling: every transaction READS the marker key (a
    conflict range) and then writes its own id to it. Two copies of the
    same logical transaction therefore conflict, so on
    commit_unknown_result the client can safely re-issue the SAME ops in
    a fresh transaction and loop — whichever copy lands first aborts the
    other, and the marker tells which id committed. No race window
    remains between "read the marker" and "the in-flight copy lands"."""

    name = "FuzzApiCorrectness"

    @property
    def _prefix(self) -> bytes:
        return b"fuzz%d/" % self.ctx.client_id

    def _k(self) -> bytes:
        return self._prefix + b"%03d" % self.ctx.rng.random_int(0, 24)

    async def start(self, db: Database) -> None:
        from ..core.types import Mutation

        rng = self.ctx.rng
        model = MemoryKeyValueStore()
        pre = self._prefix
        marker = pre + b"!txn"
        txns = int(self.ctx.options.get("transactions", 20))
        for txn_id in range(1, txns + 1):
            # Build this transaction's op list once; commits may re-issue it.
            ops: List = []
            for _ in range(rng.random_int(1, 8)):
                op = rng.random_int(0, 6)
                if op == 0:
                    ops.append(("set", self._k(), b"v%d" % rng.random_int(0, 1000)))
                elif op == 1:
                    ops.append(("clear", self._k()))
                elif op == 2:
                    a, b = sorted([self._k(), self._k()])
                    ops.append(("clear_range", a, b))
                elif op == 3:
                    ops.append(("get", self._k()))
                elif op == 4:
                    a, b = sorted([self._k(), self._k()])
                    ops.append(("get_range", a, b))
                else:
                    ops.append(("atomic_add", self._k(),
                                rng.random_int(1, 9).to_bytes(8, "little")))

            async def attempt(check_ryw: bool):
                """One execution of the op list; returns staged mutations."""
                tr = db.create_transaction()
                # conflict guard vs our twin — and if the twin already
                # landed, do NOT apply a second copy on top of it
                if await tr.get(marker) == b"%06d" % txn_id:
                    return "already"
                staged: List[Mutation] = []
                view = MemoryKeyValueStore()  # model + staged, maintained
                view._d = dict(model._d)
                for op in ops:
                    kind = op[0]
                    n_before = len(tr.mutations)
                    if kind == "set":
                        tr.set(op[1], op[2])
                    elif kind == "clear":
                        tr.clear(op[1])
                    elif kind == "clear_range":
                        tr.clear_range(op[1], op[2])
                    elif kind == "atomic_add":
                        tr.atomic_op(op[1], op[2], MutationType.ADD_VALUE)
                    elif kind == "get":
                        got = await tr.get(op[1])
                        if check_ryw:
                            assert got == view.get(op[1]), (op, got)
                    else:
                        got = await tr.get_range(op[1], op[2])
                        if check_ryw:
                            assert got == view.get_range(op[1], op[2]), op
                    for m in tr.mutations[n_before:]:
                        staged.append(m)
                        view.apply_mutation(m)
                tr.set(marker, b"%06d" % txn_id)
                staged.append(tr.mutations[-1])
                await tr.commit()
                return staged

            committed_staged = None
            check_ryw = True
            while True:
                try:
                    committed_staged = await attempt(check_ryw)
                    if committed_staged == "already":
                        committed_staged = "landed"
                    break
                except error.FDBError as e:
                    if e.is_maybe_committed():
                        # Re-issue; the marker read makes twins conflict.
                        # RYW asserts are skipped on replays: the first copy
                        # may have landed, changing the base the model knows.
                        check_ryw = False
                        async def read_marker(tr2):
                            return await tr2.get(marker)
                        if await db.run(read_marker) == b"%06d" % txn_id:
                            committed_staged = "landed"
                            break
                        continue
                    if e.is_retryable():
                        continue
                    raise
            if committed_staged == "landed":
                # the in-flight copy won; rebuild its staged effects by
                # replaying ops against the model (deterministic op list)
                view = MemoryKeyValueStore()
                view._d = dict(model._d)
                for op in ops:
                    if op[0] == "set":
                        view.apply_mutation(Mutation(MutationType.SET_VALUE, op[1], op[2]))
                    elif op[0] == "clear":
                        from ..core.types import key_after
                        view.apply_mutation(Mutation(MutationType.CLEAR_RANGE, op[1], key_after(op[1])))
                    elif op[0] == "clear_range":
                        if op[1] < op[2]:
                            view.apply_mutation(Mutation(MutationType.CLEAR_RANGE, op[1], op[2]))
                    elif op[0] == "atomic_add":
                        view.apply_mutation(Mutation(MutationType.ADD_VALUE, op[1], op[2]))
                view.set(marker, b"%06d" % txn_id)
                model = view
            else:
                for m in committed_staged:
                    model.apply_mutation(m)
            self.ctx.count("fuzz_commits")
        self.ctx.shared.setdefault("models", {})[self.ctx.client_id] = model

    async def check(self, db: Database) -> bool:
        for cid, model in self.ctx.shared.get("models", {}).items():
            pre = b"fuzz%d/" % cid

            async def read_all(tr):
                return await tr.get_range(pre, pre + b"\xff")

            got = await db.run(read_all)
            if got != model.get_range(pre, pre + b"\xff"):
                return False
        return True


class SerializabilityWorkload(TestWorkload):
    """Write-skew + invariant checks that snapshot isolation would violate
    but serializability forbids (Serializability.actor.cpp's intent,
    reduced to two classic anomalies):

      * on-call constraint: each txn reads BOTH duty keys and may resign
        (zero its own) only if the other is still on duty — serializable
        histories always leave >= 1 on duty;
      * bank transfers: total balance is invariant under concurrent
        read-check-move transactions."""

    name = "Serializability"

    #: keys deliberately spread across the keyspace so duty pairs and
    #: transfers straddle resolver shards — a broken cross-resolver vote
    #: combine is invisible to single-shard transactions
    DUTY_A = b"\x10ser/dutyA"
    DUTY_B = b"\xd0ser/dutyB"

    @staticmethod
    def bank_key(i: int, n: int) -> bytes:
        return bytes([(256 * i) // n]) + b"ser/bank/%d" % i

    async def start(self, db: Database) -> None:
        rng = self.ctx.rng
        me = self.ctx.client_id
        n_banks = 4
        if me == 0 and self.ctx.client_count > 0:
            async def init(tr):
                tr.set(self.DUTY_A, b"1")
                tr.set(self.DUTY_B, b"1")
                for i in range(n_banks):
                    tr.set(self.bank_key(i, n_banks), b"100")
            await db.run(init)
            self.ctx.shared["initialized"] = True
        while not self.ctx.shared.get("initialized"):
            await delay(0.1)

        rounds = int(self.ctx.options.get("rounds", 10))
        for _ in range(rounds):
            if rng.random01() < 0.5:
                # write-skew attempt: resignations are PERMANENT — under
                # serializability at most one duty key can ever reach 0
                # (the second resigner must see the first's write), so the
                # invariant is observable mid-run AND at check time; a
                # snapshot-isolation-only resolver lets both clients
                # resign concurrently
                mine = self.DUTY_A if rng.random01() < 0.5 else self.DUTY_B
                other = self.DUTY_B if mine == self.DUTY_A else self.DUTY_A

                async def resign(tr):
                    a = int(await tr.get(mine) or b"0")
                    b = int(await tr.get(other) or b"0")
                    if a + b >= 2:
                        tr.set(mine, b"0")
                        return True
                    return False

                if await db.run(resign):
                    self.ctx.count("resignations")

                async def observe(tr):
                    return (int(await tr.get(self.DUTY_A) or b"0")
                            + int(await tr.get(self.DUTY_B) or b"0"))

                if await db.run(observe) < 1:
                    self.ctx.shared["write_skew_observed"] = True
            else:
                i, j = rng.random_int(0, n_banks), rng.random_int(0, n_banks)
                if i == j:
                    continue
                amt = rng.random_int(1, 40)
                ki, kj = self.bank_key(i, n_banks), self.bank_key(j, n_banks)

                async def transfer(tr):
                    a = int(await tr.get(ki) or b"0")
                    if a >= amt:
                        b = int(await tr.get(kj) or b"0")
                        tr.set(ki, str(a - amt).encode())
                        tr.set(kj, str(b + amt).encode())

                await db.run(transfer)
                self.ctx.count("transfers")

    async def check(self, db: Database) -> bool:
        n_banks = 4

        async def read(tr):
            duty = [int(await tr.get(self.DUTY_A) or b"0"),
                    int(await tr.get(self.DUTY_B) or b"0")]
            total = 0
            for i in range(n_banks):
                total += int(await tr.get(self.bank_key(i, n_banks)) or b"0")
            return duty, total

        duty, total = await db.run(read)
        # at least one on duty (no write skew, final AND mid-run) and
        # balance conserved
        return (sum(duty) >= 1 and total == 400
                and not self.ctx.shared.get("write_skew_observed"))


class InventoryWorkload(TestWorkload):
    """Conditional read-modify-writes over per-item stock counters
    (Inventory.actor.cpp): restock or (only if in stock) take one item.
    The final physical stock must equal restocks minus takes — lost
    updates or phantom takes break the equation."""

    name = "Inventory"

    async def start(self, db: Database) -> None:
        rng = self.ctx.rng
        items = int(self.ctx.options.get("items", 6))
        ops = int(self.ctx.options.get("ops", 15))
        me = self.ctx.client_id
        for op_i in range(ops):
            item = b"inv/%02d" % rng.random_int(0, items)
            want_take = rng.random01() < 0.45
            # per-op marker: a maybe-committed retry must neither re-apply
            # the RMW nor double-count (the marker read is also the
            # conflict guard that serializes the retry against its twin)
            marker = b"inv!/%02d/%04d" % (me, op_i)

            async def body(tr):
                prev = await tr.get(marker)
                if prev is not None:
                    return prev.decode()   # the earlier attempt landed
                stock = int(await tr.get(item) or b"0")
                if want_take and stock > 0:
                    tr.set(item, str(stock - 1).encode())
                    action = "take"
                else:
                    tr.set(item, str(stock + 1).encode())
                    action = "restock"
                tr.set(marker, action.encode())
                return action

            what = await db.run(body)
            self.ctx.count("takes" if what == "take" else "restocks")

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"inv/", b"inv0")

        rows = await db.run(read_all)
        stock = sum(int(v) for _, v in rows)
        if any(int(v) < 0 for _, v in rows):
            return False
        return stock == (self.ctx.shared.get("restocks", 0)
                         - self.ctx.shared.get("takes", 0))


class BulkLoadWorkload(TestWorkload):
    """Sequential batch loading (BulkLoad.actor.cpp): each client commits
    `batches` transactions of `batch_size` contiguous rows; every row must
    land exactly once, and the sustained load rate is reported."""

    name = "BulkLoad"

    async def start(self, db: Database) -> None:
        from ..sim.loop import now

        me = self.ctx.client_id
        batches = int(self.ctx.options.get("batches", 6))
        size = int(self.ctx.options.get("batch_size", 40))
        t0 = now()
        for b in range(batches):
            async def body(tr):
                for i in range(size):
                    tr.set(b"bulk/%02d/%04d" % (me, b * size + i), b"x" * 16)
            await db.run(body)
            self.ctx.count("rows_loaded", size)
        dt = max(now() - t0, 1e-9)
        # count() sums across clients (rates add: total cluster rate)
        self.ctx.count("bulk_rows_per_sec", round(batches * size / dt, 1))

    async def check(self, db: Database) -> bool:
        me = self.ctx.client_id
        batches = int(self.ctx.options.get("batches", 6))
        size = int(self.ctx.options.get("batch_size", 40))

        async def count(tr):
            return len(await tr.get_range(b"bulk/%02d/" % me, b"bulk/%02d0" % me,
                                          limit=100_000))

        return await db.run(count) == batches * size


class QueuePushWorkload(TestWorkload):
    """Contended queue appends via versionstamped keys
    (QueuePush.actor.cpp): pushes never conflict, land in commit order,
    and the queue length equals the number of committed pushes."""

    name = "QueuePush"

    async def start(self, db: Database) -> None:
        import struct

        pushes = int(self.ctx.options.get("pushes", 12))
        me = self.ctx.client_id
        for i in range(pushes):
            tr = db.create_transaction()
            raw_key = b"queue/" + b"\x00" * 10 + struct.pack("<i", len(b"queue/"))
            tr.atomic_op(raw_key, b"%02d:%04d" % (me, i),
                         MutationType.SET_VERSIONSTAMPED_KEY)
            try:
                await tr.commit()
                self.ctx.count("pushes")
            except error.FDBError as e:
                if not e.is_retryable() and not e.is_maybe_committed():
                    raise
                if e.is_maybe_committed():
                    self.ctx.count("maybe_pushes")

    async def check(self, db: Database) -> bool:
        async def read_all(tr):
            return await tr.get_range(b"queue/", b"queue0", limit=100_000)

        rows = await db.run(read_all)
        keys = [k for k, _ in rows]
        if keys != sorted(keys):
            return False
        certain = self.ctx.shared.get("pushes", 0)
        maybe = self.ctx.shared.get("maybe_pushes", 0)
        if not (certain <= len(rows) <= certain + maybe):
            return False
        # commit order: each client's sequence numbers must be increasing
        # along the versionstamped key order (QueuePush.actor.cpp's check)
        last_seq: Dict[bytes, int] = {}
        for _k, v in rows:
            client, seq = v.split(b":")
            if client in last_seq and int(seq) <= last_seq[client]:
                return False
            last_seq[client] = int(seq)
        return True


class ThroughputWorkload(TestWorkload):
    """The timed 90/10 measurement loop (Throughput.actor.cpp): runs for
    a fixed virtual duration and reports transactions/sec as a metric the
    spec harness records."""

    name = "Throughput"

    async def start(self, db: Database) -> None:
        from ..sim.loop import now

        rng = self.ctx.rng
        seconds = float(self.ctx.options.get("seconds", 5.0))
        keys = int(self.ctx.options.get("keys", 128))
        t0 = now()
        done = 0
        while now() - t0 < seconds:
            async def body(tr):
                for _ in range(9):
                    await tr.get(b"tp/%04d" % rng.random_int(0, keys))
                tr.set(b"tp/%04d" % rng.random_int(0, keys), b"v")
            try:
                await db.run(body)
                done += 1
            except error.FDBError:
                pass
        self.ctx.count("throughput_txns", done)
        self.ctx.count("txns_per_sec", round(done / (now() - t0), 1))


class FullClusterRebootWorkload(TestWorkload):
    """The restarting-test shape (tests/restarting/ + SaveAndKill.actor.cpp):
    after `delay_before`, REBOOT-kill EVERY process in the cluster at once —
    coordinators included. The whole database must re-form from disks alone
    (coordination registers, tlog queues + spill, the storage LSM engines),
    and the surrounding workloads' invariants must hold across the gap."""

    name = "FullClusterReboot"
    anti_quiescence = True

    async def start(self, db: Database) -> None:
        from ..sim.simulator import KillType

        if self.ctx.client_id != 0:
            return
        await delay(float(self.ctx.options.get("delay_before", 6.0)))
        cluster = self.ctx.cluster
        sim = cluster.sim
        for p in getattr(cluster, "coord_procs", []) + cluster.worker_procs:
            if p.alive:
                sim.kill_process(p, KillType.REBOOT)
        self.ctx.count("full_reboots")
        rounds = int(self.ctx.options.get("rounds", 1))
        for _ in range(rounds - 1):
            await delay(float(self.ctx.options.get("interval", 12.0)))
            for p in getattr(cluster, "coord_procs", []) + cluster.worker_procs:
                if p.alive:
                    sim.kill_process(p, KillType.REBOOT)
            self.ctx.count("full_reboots")


class DatacenterKillWorkload(TestWorkload):
    """Kill EVERY process of one datacenter at once (the multi-region
    failure the topology exists to survive): coordinators, txn roles, and
    storage replicas of `dc` all go down; with satellite logs + cross-DC
    teams + a surviving coordinator majority, the next recovery recruits
    in the other DC and nothing acknowledged is lost. With `revive` the
    DC returns later (REBOOT), rejoining as the secondary."""

    name = "DatacenterKill"
    anti_quiescence = True

    async def start(self, db: Database) -> None:
        from ..sim.simulator import KillType

        if self.ctx.client_id != 0:
            return
        await delay(float(self.ctx.options.get("delay_before", 5.0)))
        dc = self.ctx.options.get("dc", "dc0")
        cluster = self.ctx.cluster
        sim = cluster.sim
        victims = [p for p in (getattr(cluster, "coord_procs", [])
                               + cluster.worker_procs)
                   if p.alive and p.dc_id == dc]
        for p in victims:
            sim.kill_process(p, KillType.KILL_INSTANTLY)
        self.ctx.count("dc_killed", len(victims))
        revive_after = float(self.ctx.options.get("revive_after", 0.0))
        if revive_after > 0:
            await delay(revive_after)
            for p in victims:
                sim.revive_process(p)
            self.ctx.count("dc_revived")


class DeviceFaultValidationWorkload(TestWorkload):
    """Check-phase auditor for the device-nemesis campaign (fault/).

    Every ResilientEngine the simulation created — including engines of
    generations whose processes have since died — must have emitted a
    bit-identical verdict stream: its journal replayed through a fresh
    reference oracle reproduces every abort set exactly, injected
    exceptions/hangs/slow batches, watchdog retries, CPU-oracle failovers
    and swap-backs notwithstanding. Health counters are folded into the
    spec metrics so a multi-seed campaign can assert failover and
    swap-back coverage."""

    name = "DeviceFaultCheck"

    HEALTH_KEYS = ("failovers", "swap_backs", "retries", "dispatch_faults",
                   "probes", "probe_mismatches", "oracle_batches",
                   "rewarm_failures")

    async def check(self, db: Database) -> bool:
        from ..core.trace import Severity, TraceEvent
        from ..fault import abort_set_digest, registered_engines
        from ..ops.oracle import OracleConflictEngine

        ok = True
        engines = registered_engines()
        self.ctx.count("engines_checked", len(engines))
        for eng in engines:
            st = eng.health_stats()
            for k in self.HEALTH_KEYS:
                self.ctx.count(f"engine_{k}", st.get(k, 0))
            if st.get("probe_mismatches"):
                # a quarantine means corruption reached the verdict stream
                # at least once before the probe caught it — SevError, and
                # the spec fails (flips are off in nemesis defaults; this
                # arm exists for the corruption-variant runs)
                ok = False
            if eng.journal is None:
                continue
            # flight recorder (docs/observability.md): the incident ring's
            # abort-set digests must replay — each recorded dispatch's
            # digest equals the digest of a clean oracle's verdicts for the
            # same batch (post-mortem parity without the full journal)
            flight_by_version = {rec["version"]: rec
                                 for rec in eng.flight.dump()}
            self.ctx.count("flight_records", len(flight_by_version))
            # heat/occupancy snapshots riding the records: replay
            # tolerates their presence and checks the fields are sane —
            # a malformed snapshot in an incident dump is itself a bug
            for rec in flight_by_version.values():
                heat = rec.get("heat")
                if heat is None:
                    continue
                self.ctx.count("flight_heat_records")
                frac = heat.get("occupancy_frac", 0.0)
                if not (0.0 <= frac <= 1.0) or heat.get("conflicts", 0) < 0:
                    TraceEvent("FlightRecorderHeatMalformed",
                               severity=Severity.ERROR) \
                        .detail("Version", rec["version"]) \
                        .detail("Heat", heat).log()
                    self.ctx.count("flight_heat_malformed")
                    ok = False
            clean = OracleConflictEngine()
            for version, txns, new_oldest, verdicts in eng.journal:
                want = clean.resolve(list(txns), version, new_oldest)
                if list(verdicts) != [int(v) for v in want]:
                    TraceEvent("DeviceFaultParityMismatch",
                               severity=Severity.ERROR) \
                        .detail("Version", version) \
                        .detail("Got", list(verdicts)) \
                        .detail("Want", [int(v) for v in want]).log()
                    self.ctx.count("parity_mismatches")
                    ok = False
                    break
                rec = flight_by_version.get(version)
                if rec is not None and rec["digest"] != abort_set_digest(want):
                    TraceEvent("FlightRecorderDigestMismatch",
                               severity=Severity.ERROR) \
                        .detail("Version", version) \
                        .detail("Recorded", rec["digest"]) \
                        .detail("Replayed", abort_set_digest(want)).log()
                    self.ctx.count("flight_digest_mismatches")
                    ok = False
                    break
        return ok
