"""Database + Transaction: the client of the transaction system.

Port of ``foundationdb_tpu/client/database.py``.

Round-1 scope of fdbclient/NativeAPI.actor.cpp + ReadYourWrites.actor.cpp:

  * GRV from the proxy (readVersionBatcher batches on the proxy side here)
  * key -> storage-server location cache filled from the proxy
    (getKeyLocation_internal:1028) with wrong_shard_server invalidation
  * reads at the read version from storage replicas (getValue:1165,
    getRange:1604), recording read conflict ranges (unless snapshot)
  * a read-your-writes overlay: uncommitted sets/clears/atomic-ops are
    visible to this transaction's own reads (WriteMap semantics)
  * commit via the proxy; on_error implements the reference's retry loop
    with randomized exponential backoff (Transaction::onError:2630)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import error
from ..core.knobs import CLIENT_KNOBS
from ..core.types import (
    CommitTransaction,
    Key,
    KeyRange,
    Mutation,
    MutationType,
    SINGLE_KEY_MUTATIONS,
    VERSIONSTAMP_MUTATIONS,
    Value,
    Version,
    apply_atomic_op,
    key_after,
    place_versionstamp,
    single_key_range,
    validate_versionstamp_param,
)
from ..sim.loop import TaskPriority, current_scheduler, delay
from ..sim.network import Endpoint
from ..server import proxy as proxy_mod
from ..server import storage as storage_mod
from ..server.messages import (
    CommitTransactionRequest,
    GetKeyValuesRequest,
    GetKeyServerLocationsRequest,
    GetReadVersionRequest,
    GetValueRequest,
    WatchValueRequest,
)


class KeySelector:
    """reference: KeySelectorRef (fdbclient/FDBTypes.h) — resolves to the
    key at `offset` relative to the anchor position defined by (key,
    or_equal): with i0 = the index of the first database key > key (if
    or_equal) or >= key (if not), the selector resolves to the key at
    index i0 + offset - 1, clamped to b"" / the end of the keyspace."""

    __slots__ = ("key", "or_equal", "offset")

    def __init__(self, key: Key, or_equal: bool, offset: int):
        self.key = key
        self.or_equal = or_equal
        self.offset = offset

    @classmethod
    def first_greater_or_equal(cls, key: Key) -> "KeySelector":
        return cls(key, False, 1)

    @classmethod
    def first_greater_than(cls, key: Key) -> "KeySelector":
        return cls(key, True, 1)

    @classmethod
    def last_less_than(cls, key: Key) -> "KeySelector":
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key: Key) -> "KeySelector":
        return cls(key, True, 0)

MAX_BACKOFF = 1.0
INITIAL_BACKOFF = 0.01
USER_KEYSPACE_END = b"\xff"
#: per-request reply timeout (virtual seconds). A partition between client
#: and a role must surface as a retryable error, never a hung future
#: (reference: the failure monitor + connection break give the same bound).
REQUEST_TIMEOUT = 5.0

_WRONG_SHARD = error.wrong_shard_server("").code
_MAYBE_DELIVERED = error.request_maybe_delivered("").code
_CONNECTION_FAILED = error.connection_failed("").code


def _map_read_error(e: error.FDBError) -> error.FDBError:
    """Reads are idempotent: a maybe-delivered request is safely retryable,
    so surface it as connection_failed (which on_error retries). The
    reference gets this for free from loadBalance re-issuing to replicas."""
    if e.code == _MAYBE_DELIVERED:
        return error.connection_failed("retrying idempotent read")
    return e


class Database:
    def __init__(self, net, client_addr: str, proxy_addrs: Optional[List[str]] = None,
                 coordinator_addrs: Optional[List[str]] = None):
        """Static mode (fixed proxy_addrs) or dynamic mode: given
        coordinator addresses — the cluster file — the client elects its
        view of the cluster controller by majority and fetches the proxy
        list from it, re-fetching whenever proxies fail (reference:
        MonitorLeader + openDatabase, NativeAPI/MonitorLeader.actor.cpp)."""
        self.net = net
        self.client_addr = client_addr
        from ..core.keyrangemap import KeyRangeMap as _KRM

        self.proxy_addrs = list(proxy_addrs or [])
        self.coordinator_addrs = list(coordinator_addrs or [])
        # location cache: a coalescing KeyRangeMap (the reference's
        # locationCache KeyRangeMap, NativeAPI.actor.cpp:1028); value =
        # tuple of storage addrs, None = unknown
        self._locations = _KRM(default=None)
        # rotates reads across a shard's replica team (loadBalance)
        self._lb_counter: int = 0
        # QueueModel (fdbrpc/QueueModel.cpp): per-replica latency EWMA +
        # failure penalty; the preferred replica is the model's best, with
        # periodic exploration so a recovered replica re-earns traffic
        self._queue_model: Dict[str, float] = {}

    def _proxy(self) -> str:
        rng = current_scheduler().rng
        return self.proxy_addrs[rng.random_int(0, len(self.proxy_addrs))]

    async def _get_proxy(self) -> str:
        while not self.proxy_addrs:
            if not self.coordinator_addrs:
                raise error.connection_failed("no proxies and no coordinators")
            await self._refresh_proxies()
        return self._proxy()

    def note_proxy_failure(self) -> None:
        """A proxy request failed at the transport level: in dynamic mode,
        drop the cached proxy list so the next request re-discovers (the
        generation may have turned over)."""
        if self.coordinator_addrs:
            self.proxy_addrs = []

    async def _refresh_proxies(self) -> None:
        from ..server.cluster_controller import (
            CC_OPEN_DATABASE_TOKEN,
            OpenDatabaseRequest,
        )
        from ..server.leader_election import tally_leader_once

        leader = await tally_leader_once(self.net, self.client_addr,
                                         self.coordinator_addrs)
        if leader is not None:
            try:
                info = await self.net.request(
                    self.client_addr, Endpoint(leader.address, CC_OPEN_DATABASE_TOKEN),
                    OpenDatabaseRequest(), TaskPriority.DEFAULT_ENDPOINT, timeout=1.0,
                )
            except error.FDBError:
                info = None
            if info is not None and info.recovery_state == "fully_recovered" and info.proxy_addrs:
                self.proxy_addrs = list(info.proxy_addrs)
                return
        await delay(0.25)

    async def get_status(self) -> Optional[dict]:
        """Fetch the cluster status document from the CC (StatusClient)."""
        from ..server.cluster_controller import CC_STATUS_TOKEN
        from ..server.leader_election import tally_leader_once

        leader = await tally_leader_once(self.net, self.client_addr,
                                         self.coordinator_addrs)
        if leader is None:
            return None
        try:
            return await self.net.request(
                self.client_addr, Endpoint(leader.address, CC_STATUS_TOKEN),
                None, TaskPriority.DEFAULT_ENDPOINT, timeout=2.0,
            )
        except error.FDBError:
            return None

    def create_transaction(self) -> "Transaction":
        return Transaction(self)

    async def run(self, fn, *args):
        """Retry loop (the @fdb.transactional decorator of the bindings):
        fn(tr, *args) is retried until commit succeeds."""
        tr = self.create_transaction()
        while True:
            try:
                result = await fn(tr, *args)
                await tr.commit()
                return result
            except error.FDBError as e:
                await tr.on_error(e)

    # -- location cache ------------------------------------------------------
    def invalidate_cache(self) -> None:
        self._locations.clear(default=None)

    async def get_locations(self, begin: Key, end: Key) -> List[Tuple[KeyRange, List[str]]]:
        from ..core import buggify

        if buggify.buggify():
            self.invalidate_cache()   # spontaneous cache loss (sim only)
        covered = self._cached_locations(begin, end)
        if covered is not None:
            return covered
        try:
            reply = await self.net.request(
                self.client_addr,
                Endpoint(await self._get_proxy(), proxy_mod.LOCATIONS_TOKEN),
                GetKeyServerLocationsRequest(begin=begin, end=end),
                TaskPriority.DEFAULT_ENDPOINT,
                timeout=REQUEST_TIMEOUT,
            )
        except error.FDBError as e:
            if e.code in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                self.note_proxy_failure()
            raise _map_read_error(e)
        for rng, addrs in reply.results:
            self._insert_location(rng, addrs)
        return reply.results

    def _cached_locations(self, begin: Key, end: Key) -> Optional[List[Tuple[KeyRange, List[str]]]]:
        out = []
        for cb, ce, addrs in self._locations.intersecting(begin, end):
            if addrs is None or ce is None:
                return None   # a gap: the whole span must re-resolve
            out.append((KeyRange(cb, ce), list(addrs)))
        return out or None

    def _insert_location(self, rng: KeyRange, addrs: List[str]) -> None:
        self._locations.insert(rng.begin, rng.end, tuple(addrs))

    # -- replica load balancing ---------------------------------------------
    async def storage_request(self, addrs: List[str], token: str, req,
                              priority: int = TaskPriority.DEFAULT_ENDPOINT,
                              timeout: float = 0.0, hedge: bool = True):
        """loadBalance (fdbrpc/LoadBalance.actor.h:158): reads spread
        across a shard's replica team, fail over on transport loss, and
        HEDGE — when the preferred replica is slow (read_hedge_delay), a
        second request races it on the next replica and the first answer
        wins (the reference's second-request machinery, :413). Reads are
        idempotent, so duplicates are safe. Non-transport errors
        (wrong_shard, future_version, ...) surface immediately — they come
        from a live replica and would repeat."""
        from ..core import buggify

        self._lb_counter += 1
        # QueueModel ordering: lowest expected latency first; every 8th
        # request explores round-robin so a slow-marked replica that
        # recovered re-earns traffic (the reference decays its penalties)
        if self._lb_counter % 8 == 0 or all(
            a not in self._queue_model for a in addrs
        ):
            start = self._lb_counter % len(addrs)
            order = [addrs[(start + i) % len(addrs)] for i in range(len(addrs))]
        else:
            order = sorted(addrs, key=lambda a: self._queue_model.get(a, 0.0))
        if buggify.buggify():
            # sticky replica preference: all reads pile onto one replica,
            # exercising hedging and server-side shedding instead of the
            # rotation hiding them
            order = sorted(addrs)
        to = timeout or REQUEST_TIMEOUT
        from ..sim.loop import now as _now

        def _observe(addr: str, dt: float) -> None:
            old_v = self._queue_model.get(addr, dt)
            self._queue_model[addr] = 0.75 * old_v + 0.25 * dt

        def send(i: int):
            addr = order[i % len(order)]
            t0 = _now()
            f = self.net.request(
                self.client_addr, Endpoint(addr, token), req,
                priority, timeout=to,
            )

            def done(fut) -> None:
                if fut.is_error:
                    try:
                        fut.get()
                    except error.FDBError as e:
                        if e.code in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                            # transport loss: heavy penalty pushes the
                            # replica back until it recovers
                            _observe(addr, to)
                        else:
                            # wrong_shard/future_version etc. came from a
                            # LIVE replica answering promptly: its latency
                            # is the reply time, not a penalty
                            _observe(addr, _now() - t0)
                    except BaseException:
                        pass
                else:
                    _observe(addr, _now() - t0)

            f.on_ready(done)
            return f

        if hedge and len(addrs) > 1:
            from ..sim.actors import any_of, ready_or_error

            first = send(0)
            which, _ = await any_of(
                [ready_or_error(first), delay(CLIENT_KNOBS.read_hedge_delay, priority)]
            )
            if which == 0 and not first.is_error:
                return first.get()
            if which == 0:
                # fast failure: fall through to plain failover on the rest
                try:
                    first.get()
                except error.FDBError as e:
                    if e.code not in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                        raise
                order = order[1:] + order[:1]
            else:
                # slow replica: race a hedge on the next one
                second = send(1)
                got = await any_of([ready_or_error(first), ready_or_error(second)])
                winner = (first, second)[got[0]]
                other = (second, first)[got[0]]
                if not winner.is_error:
                    return winner.get()
                try:
                    winner.get()
                except error.FDBError as e:
                    if e.code not in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                        raise
                await ready_or_error(other)
                if not other.is_error:
                    return other.get()
                try:
                    other.get()
                except error.FDBError as e:
                    if e.code not in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                        raise
                order = order[2:] + order[:2]

        last: Optional[error.FDBError] = None
        for i in range(len(addrs)):
            try:
                return await send(i)
            except error.FDBError as e:
                if e.code in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                    last = e
                    continue
                raise
        raise last if last is not None else error.connection_failed()


class Transaction:
    def __init__(self, db: Database):
        self.db = db
        self.read_version: Optional[Version] = None
        self.mutations: List[Mutation] = []
        self.read_conflict_ranges: List[KeyRange] = []
        self.write_conflict_ranges: List[KeyRange] = []
        self.committed_version: Optional[Version] = None
        self.committed_batch_index: int = 0
        self._backoff = INITIAL_BACKOFF
        self._committing = False
        self._access_system_keys = False
        self._lock_aware = False

    # -- versions ------------------------------------------------------------
    async def get_read_version(self) -> Version:
        if self.read_version is None:
            try:
                reply = await self.db.net.request(
                    self.db.client_addr,
                    Endpoint(await self.db._get_proxy(), proxy_mod.GRV_TOKEN),
                    GetReadVersionRequest(),
                    TaskPriority.GET_CONSISTENT_READ_VERSION,
                    timeout=REQUEST_TIMEOUT,
                )
            except error.FDBError as e:
                if e.code in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                    self.db.note_proxy_failure()
                raise _map_read_error(e)
            self.read_version = reply.version
        return self.read_version

    # -- the RYW overlay -----------------------------------------------------
    def _overlay_value(self, key: Key, base: Optional[Value]) -> Optional[Value]:
        """Apply this transaction's own buffered mutations for `key` on top
        of the storage value (WriteMap semantics, fdbclient/WriteMap.h)."""
        v = base
        for m in self.mutations:
            if m.type in VERSIONSTAMP_MUTATIONS:
                # The stamped bytes are unknown until commit; reading a key
                # this transaction versionstamped is an error (reference:
                # RYW marks these ranges unreadable, error 1036).
                if m.param1 == key:
                    raise error.accessed_unreadable()
                continue
            if m.type == MutationType.SET_VALUE and m.param1 == key:
                v = m.param2
            elif m.type == MutationType.CLEAR_RANGE and m.param1 <= key < m.param2:
                v = None
            elif m.type in SINGLE_KEY_MUTATIONS and m.param1 == key:
                v = apply_atomic_op(m.type, v, m.param2)
        return v

    def _needs_base_read(self, key: Key) -> bool:
        """False when buffered mutations fully determine the value: any SET
        or covering CLEAR makes the storage base irrelevant (atomic ops after
        it apply to a known value)."""
        for m in self.mutations:
            if m.type == MutationType.SET_VALUE and m.param1 == key:
                return False
            if m.type == MutationType.CLEAR_RANGE and m.param1 <= key < m.param2:
                return False
        return True

    # -- reads ---------------------------------------------------------------
    async def get(self, key: Key, snapshot: bool = False) -> Optional[Value]:
        version = await self.get_read_version()
        if not snapshot:
            self.read_conflict_ranges.append(single_key_range(key))
        base: Optional[Value] = None
        if self._needs_base_read(key):
            base = await self._storage_get(key, version)
        return self._overlay_value(key, base)

    async def get_range(
        self, begin: Key, end: Key, limit: int = 10_000, snapshot: bool = False, reverse: bool = False
    ) -> List[Tuple[Key, Value]]:
        if begin >= end:
            return []
        version = await self.get_read_version()
        # With buffered mutations the overlay may add/remove rows, so the
        # storage limit cannot be trusted; fetch the whole range (paged).
        fetch_limit = limit if not self.mutations else None
        data, server_truncated = await self._storage_get_range(
            begin, end, version, fetch_limit, reverse
        )
        merged = self._overlay_range(begin, end, data)
        if reverse:
            merged = sorted(merged, key=lambda kv: kv[0], reverse=True)
        result = merged[:limit]
        if not snapshot:
            # When the limit truncates the read, narrow the conflict range to
            # the keys actually observed (reference: ReadYourWrites narrows
            # to the returned ranges) — a write past the last returned key
            # was never read and must not abort us. Truncation happens either
            # in the overlay (len(merged) > limit) or at the storage server
            # (server_truncated, via GetKeyValuesReply.more).
            if (len(merged) > limit or server_truncated) and result:
                if reverse:
                    self.read_conflict_ranges.append(KeyRange(result[-1][0], end))
                else:
                    self.read_conflict_ranges.append(KeyRange(begin, key_after(result[-1][0])))
            else:
                self.read_conflict_ranges.append(KeyRange(begin, end))
        return result

    def _overlay_range(
        self, begin: Key, end: Key, data: List[Tuple[Key, Value]]
    ) -> List[Tuple[Key, Value]]:
        if not self.mutations:
            return list(data)
        result: Dict[Key, Optional[Value]] = dict(data)
        for m in self.mutations:
            if m.type in VERSIONSTAMP_MUTATIONS:
                if begin <= m.param1 < end:
                    raise error.accessed_unreadable()
                continue
            if m.type == MutationType.SET_VALUE:
                if begin <= m.param1 < end:
                    result[m.param1] = m.param2
            elif m.type == MutationType.CLEAR_RANGE:
                for k in [k for k in result if m.param1 <= k < m.param2]:
                    result[k] = None
            elif m.type in SINGLE_KEY_MUTATIONS:
                if begin <= m.param1 < end:
                    result[m.param1] = apply_atomic_op(m.type, result.get(m.param1), m.param2)
        return sorted(
            [(k, v) for k, v in result.items() if v is not None], key=lambda kv: kv[0]
        )

    # -- storage rpc with location cache + retry -----------------------------
    async def _storage_get(self, key: Key, version: Version) -> Optional[Value]:
        fresh_tries = 0
        while True:
            locs = await self.db.get_locations(key, key_after(key))
            try:
                reply = await self.db.storage_request(
                    locs[0][1], storage_mod.GET_VALUE_TOKEN,
                    GetValueRequest(key=key, version=version),
                )
                return reply.value
            except error.FDBError as e:
                if e.code == _WRONG_SHARD:
                    self.db.invalidate_cache()
                    continue
                if e.code in (_CONNECTION_FAILED, _MAYBE_DELIVERED) and fresh_tries < 2:
                    # The whole cached team is unreachable — it may have
                    # been moved away (MoveKeys retired the old replicas).
                    # Re-resolve locations before giving up (loadBalance's
                    # allAlternativesFailed -> re-fetch).
                    fresh_tries += 1
                    self.db.invalidate_cache()
                    await delay(0.1)
                    continue
                raise _map_read_error(e)

    async def _storage_get_range(
        self, begin: Key, end: Key, version: Version, limit: Optional[int], reverse: bool
    ) -> Tuple[List[Tuple[Key, Value]], bool]:
        """limit=None fetches the whole range, paging per shard until each
        shard is exhausted. Returns (data, truncated): truncated means the
        servers may hold more rows in [begin, end) past the returned ones."""
        out: List[Tuple[Key, Value]] = []
        fresh_tries = 0
        while True:
            locs = await self.db.get_locations(begin, end)
            if reverse:
                locs = list(reversed(locs))
            try:
                for i, (rng, addrs) in enumerate(locs):
                    cb, ce = max(begin, rng.begin), min(end, rng.end)
                    while cb < ce:
                        want = 10_000 if limit is None else min(limit - len(out), 10_000)
                        reply = await self.db.storage_request(
                            addrs, storage_mod.GET_KEY_VALUES_TOKEN,
                            GetKeyValuesRequest(begin=cb, end=ce, version=version, limit=want, reverse=reverse),
                        )
                        out.extend(reply.data)
                        if limit is not None and len(out) >= limit:
                            truncated = bool(reply.more) or i + 1 < len(locs)
                            return out, truncated
                        if not reply.more or not reply.data:
                            break
                        if reverse:
                            ce = reply.data[-1][0]
                        else:
                            cb = key_after(reply.data[-1][0])
                return out, False
            except error.FDBError as e:
                if e.code == _WRONG_SHARD:
                    self.db.invalidate_cache()
                    out = []
                    continue
                if e.code in (_CONNECTION_FAILED, _MAYBE_DELIVERED) and fresh_tries < 2:
                    # dead cached team: the shard may have moved (MoveKeys)
                    fresh_tries += 1
                    self.db.invalidate_cache()
                    out = []
                    await delay(0.1)
                    continue
                raise _map_read_error(e)

    # -- writes ----------------------------------------------------------------
    def set(self, key: Key, value: Value) -> None:
        self._check_writable(key)
        self.mutations.append(Mutation(MutationType.SET_VALUE, key, value))
        self.write_conflict_ranges.append(single_key_range(key))

    def clear(self, key: Key) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: Key, end: Key) -> None:
        self._check_writable(begin)
        if end > USER_KEYSPACE_END:
            # The end bound is exclusive, so end == \xff is legal.
            raise error.key_outside_legal_range()
        if begin >= end:
            return
        self.mutations.append(Mutation(MutationType.CLEAR_RANGE, begin, end))
        self.write_conflict_ranges.append(KeyRange(begin, end))

    def atomic_op(self, key: Key, param: Value, op: MutationType) -> None:
        self._check_writable(key)
        if op in VERSIONSTAMP_MUTATIONS:
            stamped = key if op == MutationType.SET_VERSIONSTAMPED_KEY else param
            if not validate_versionstamp_param(stamped):
                raise error.client_invalid_operation(
                    "versionstamp offset out of range or param too short"
                )
        self.mutations.append(Mutation(op, key, param))
        self.write_conflict_ranges.append(single_key_range(key))

    def get_versionstamp(self) -> bytes:
        """The 10-byte versionstamp assigned at commit (reference:
        Transaction::getVersionstamp, NativeAPI.actor.cpp:2785-2792; value
        layout per fdb.options set_versionstamped_key). Only valid after a
        successful commit."""
        if self.committed_version is None:
            raise error.client_invalid_operation("get_versionstamp before commit")
        return place_versionstamp(self.committed_version, self.committed_batch_index)

    async def get_key(self, selector: KeySelector, snapshot: bool = False) -> Key:
        """Resolve a key selector (reference: Transaction::getKey,
        NativeAPI.actor.cpp:1234). Resolution scans through get_range, so
        the scanned span lands in the read conflict set exactly like the
        reference's selector reads (unless snapshot)."""
        k, or_equal, offset = selector.key, selector.or_equal, selector.offset
        if offset >= 1:
            start = key_after(k) if or_equal else k
            rows = await self.get_range(start, USER_KEYSPACE_END,
                                        limit=offset, snapshot=snapshot)
            if len(rows) >= offset:
                return rows[offset - 1][0]
            return USER_KEYSPACE_END
        n = 1 - offset
        end = key_after(k) if or_equal else k
        rows = await self.get_range(b"", end, limit=n, reverse=True,
                                    snapshot=snapshot)
        if len(rows) >= n:
            return rows[n - 1][0]
        return b""

    async def get_range_selector(self, begin: KeySelector, end: KeySelector,
                                 limit: Optional[int] = None,
                                 reverse: bool = False,
                                 snapshot: bool = False):
        """Range read with selector endpoints (getRange with selectors)."""
        b = await self.get_key(begin, snapshot=snapshot)
        e = await self.get_key(end, snapshot=snapshot)
        if b >= e:
            return []
        return await self.get_range(b, e, limit=limit if limit is not None else 10_000,
                                    reverse=reverse, snapshot=snapshot)

    def watch(self, key: Key, expected: object = ...,
              expected_version: Optional[Version] = None):
        """Future firing when `key`'s value changes from `expected`
        (reference: Transaction::watch, NativeAPI.actor.cpp:1302). With no
        `expected`, the watch snapshot-reads the current value first; pass
        the value your transaction already read (plus its read version) to
        close the read-then-watch race — the reference gets that atomicity
        from registering the watch inside the reading transaction. Survives
        storage failures by re-registering; cancel the returned task to
        stop watching."""
        from ..sim.loop import spawn

        _UNSET = object()

        async def read_current():
            """Snapshot-read key with full retry (storage may be mid-reboot
            or mid-recovery when the watch re-registers)."""
            tr = self.db.create_transaction()
            while True:
                try:
                    value = await tr.get(key, snapshot=True)
                    return value, tr.read_version
                except error.FDBError as e:
                    await tr.on_error(e)

        async def watch_actor():
            if expected is ...:
                exp, version = await read_current()
            else:
                exp = expected
                version = expected_version or self.read_version or 0
            while True:
                try:
                    locs = await self.db.get_locations(key, key_after(key))
                    # One rotated replica, NO failover: a watch is a long
                    # poll, and chaining 30s parks across the team would
                    # multiply the re-check interval by the team size.
                    addrs = locs[0][1]
                    self.db._lb_counter += 1
                    addr = addrs[self.db._lb_counter % len(addrs)]
                    return await self.db.net.request(
                        self.db.client_addr,
                        Endpoint(addr, storage_mod.WATCH_VALUE_TOKEN),
                        WatchValueRequest(key=key, value=exp, version=version),
                        TaskPriority.DEFAULT_ENDPOINT,
                        timeout=30.0,
                    )
                except error.FDBError as e:
                    if e.code == _WRONG_SHARD:
                        self.db.invalidate_cache()
                    elif not e.is_retryable() and e.code != _MAYBE_DELIVERED:
                        raise
                    # Transport loss or parked-too-long: re-read; if the
                    # value moved while we were not watching, fire now.
                    await delay(0.25)
                    current, version = await read_current()
                    if current != exp:
                        return current

        return spawn(watch_actor(), TaskPriority.DEFAULT_ENDPOINT, name=f"watch:{key!r}")

    def add_read_conflict_range(self, begin: Key, end: Key) -> None:
        self.read_conflict_ranges.append(KeyRange(begin, end))

    def add_write_conflict_range(self, begin: Key, end: Key) -> None:
        self.write_conflict_ranges.append(KeyRange(begin, end))

    def set_access_system_keys(self) -> None:
        """Allow writes to the `\\xff` system keyspace (the reference's
        ACCESS_SYSTEM_KEYS transaction option; used by ManagementAPI-class
        callers like the master's DD-lite)."""
        self._access_system_keys = True

    def set_lock_aware(self) -> None:
        """Commit through a database lock (the reference's LOCK_AWARE
        transaction option; DR's apply transactions use it against the
        locked destination)."""
        self._lock_aware = True

    def _check_writable(self, key: Key) -> None:
        if self._committing:
            raise error.used_during_commit()
        if key >= USER_KEYSPACE_END and not self._access_system_keys:
            raise error.key_outside_legal_range()

    # -- commit / retry --------------------------------------------------------
    async def commit(self) -> Version:
        if not self.mutations and not self.write_conflict_ranges:
            # Read-only transactions commit trivially (reference:
            # Transaction::commit fast path).
            self.committed_version = self.read_version or 0
            return self.committed_version
        self._committing = True
        txn = CommitTransaction(
            read_conflict_ranges=list(self.read_conflict_ranges),
            write_conflict_ranges=list(self.write_conflict_ranges),
            mutations=list(self.mutations),
            read_snapshot=await self.get_read_version(),
            # management/DR transactions commit through a database lock
            # (system-keys access implies LOCK_AWARE, like the reference's
            # ManagementAPI callers; DR applies set it explicitly)
            lock_aware=self._access_system_keys or self._lock_aware,
        )
        try:
            reply = await self.db.net.request(
                self.db.client_addr,
                Endpoint(await self.db._get_proxy(), proxy_mod.COMMIT_TOKEN),
                CommitTransactionRequest(transaction=txn),
                TaskPriority.PROXY_COMMIT,
                timeout=2 * REQUEST_TIMEOUT,
            )
        except error.FDBError as e:
            if e.code in (_MAYBE_DELIVERED, _CONNECTION_FAILED):
                self.db.note_proxy_failure()
                # The commit may or may not have happened (reference:
                # tryCommit maps transport loss to commit_unknown_result).
                raise error.commit_unknown_result(e.name)
            raise
        finally:
            self._committing = False
        self.committed_version = reply.version
        self.committed_batch_index = reply.txn_batch_index
        return reply.version

    async def on_error(self, e: error.FDBError) -> None:
        """reference: Transaction::onError (NativeAPI.actor.cpp:2630):
        retryable errors reset the transaction after randomized backoff;
        everything else re-raises."""
        if not isinstance(e, error.FDBError) or not e.is_retryable():
            raise e
        if e.code == error.transaction_too_old("").code:
            # Defense in depth for generation turnover: a deposed proxy can
            # keep answering GRV with pre-jump versions that storage has
            # already forgotten; re-resolve the proxy list so the retry
            # reaches the live generation.
            self.db.note_proxy_failure()
        from ..core import buggify

        rng = current_scheduler().rng
        backoff = self._backoff
        if buggify.buggify():
            # impatient client: minimal backoff floods the retry path and
            # stresses idempotent-commit / replay-window handling
            backoff = 0.001
        await delay(backoff * rng.random01())
        self._backoff = min(self._backoff * CLIENT_KNOBS.backoff_growth_rate,
                            CLIENT_KNOBS.max_backoff)
        self.reset()

    def reset(self) -> None:
        self.read_version = None
        self.mutations = []
        self.read_conflict_ranges = []
        self.write_conflict_ranges = []
        self._committing = False
