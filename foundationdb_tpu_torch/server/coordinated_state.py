"""Coordinated state: majority read/write of DBCoreState over coordinators.

Port of ``foundationdb_tpu/server/coordinated_state.py``.

Re-design of fdbserver/CoordinatedState.actor.cpp + DBCoreState.h. The
coordinated state is the cluster's root of trust: which tlog generation is
current, where recovery left off, and which configuration the transaction
system runs. A recovering master must (1) read it from a majority, (2)
write the new generation exclusively — losing the race to a competing
master surfaces as coordinated_state_conflict, killing the loser.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, List, Optional

from ..core import buggify, error
from ..sim.actors import all_of
from ..sim.loop import Future, TaskPriority
from ..sim.network import Endpoint
from .coordination import (
    GENERATION_READ_TOKEN,
    GENERATION_WRITE_TOKEN,
    Generation,
    GenerationReadRequest,
    GenerationWriteRequest,
    ZERO_GEN,
)

CSTATE_KEY = "dbcore"
COORD_REQUEST_TIMEOUT = 2.0


@dataclass(frozen=True)
class LogGenerationInfo:
    """One tlog generation (reference: CoreTLogSet, DBCoreState.h): its
    LogSystemConfig (membership + identity + version floor) and, once the
    epoch has ended, the recovery version it was cut at. end_version ==
    None means the generation is current (still growing)."""

    config: Any                 # LogSystemConfig (kept untyped: no cycle)
    end_version: Optional[int] = None


@dataclass(frozen=True)
class DBCoreState:
    """reference: DBCoreState (fdbserver/DBCoreState.h) — everything a new
    master needs to end the previous epoch: the recovery count and the tlog
    generations that may hold unrecovered data. Storage assignments ride
    along (the reference reads them from the txnStateStore tag; carrying
    them here keeps the seed-configuration path explicit until the system
    keyspace lands)."""

    recovery_count: int = 0
    generations: tuple = ()           # of LogGenerationInfo, oldest..newest
    storage_tags: tuple = ()          # of (tag, shard_begin, shard_end, address)
    #: resolver key-shard split keys chosen by resolutionBalancing; empty =
    #: uniform splits (masterserver.actor.cpp:919-977)
    resolver_splits: tuple = ()
    #: worker addresses excluded from hosting storage (ManagementAPI's
    #: \xff/conf/excluded analog — persisted so recoveries keep them)
    excluded: tuple = ()
    #: mirror of the committed \xff/conf/ map as sorted (key, value) byte
    #: pairs: recovery reads role counts from HERE (before any storage is
    #: reachable), the way the reference reads DatabaseConfiguration out
    #: of the recovered txnStateStore
    conf: tuple = ()


class CoordinatedState:
    """One master's handle on the replicated cstate (ReusableCoordinatedState).

    Protocol (CoordinatedState.actor.cpp): reads broadcast a fresh
    generation and take the value with the highest write generation from a
    majority; the subsequent exclusive write reuses a generation higher
    than everything seen — a competing master's interleaved read/write
    forces this writer's generation stale and its write fails.
    """

    def __init__(self, net, src_addr: str, coordinator_addrs: List[str], salt: int):
        from ..sim.actors import AsyncMutex

        self.net = net
        self.src = src_addr
        self.coords = list(coordinator_addrs)
        self.salt = salt
        self._max_seen = ZERO_GEN
        self._read_gen: Optional[Generation] = None
        #: generation the NEXT set_exclusive writes at. Starts at the read
        #: generation (the exclusivity check needs write1 == read gen);
        #: subsequent writes run a fresh read-verify-write cycle so they
        #: are ordered after our earlier writes AND any interleaved writer
        #: is detected — sequential writes from one handle MUST be ordered,
        #: or a network-delayed earlier write applying late on one
        #: coordinator silently reinstates a stale value at an equal
        #: generation and a later quorum read can return it (found by
        #: BUGGIFY reordering; the register max() can't break same-gen ties)
        self._write_gen: Optional[Generation] = None
        self._last_written: Optional[DBCoreState] = None
        self._write_mutex = AsyncMutex()

    @property
    def _majority(self) -> int:
        return len(self.coords) // 2 + 1

    async def _broadcast(self, token: str, req_for) -> List[Any]:
        """Send to every coordinator; return the successful majority of
        replies (error if a majority is unreachable)."""
        if buggify.buggify():
            # skewed quorum broadcast: a straggling master's ops interleave
            # with a competitor's — the generation math must stay exclusive
            from ..sim.loop import delay
            await delay(0.1, TaskPriority.COORDINATION)
        futures = [
            self.net.request(
                self.src, Endpoint(addr, token), req_for(addr),
                TaskPriority.COORDINATION, timeout=COORD_REQUEST_TIMEOUT,
            )
            for addr in self.coords
        ]
        out = Future()
        replies: List[Any] = []
        state = {"err": 0}
        n = len(futures)

        def one(f) -> None:
            if out.is_ready:
                return
            if f.is_error:
                state["err"] += 1
                if n - state["err"] < self._majority:
                    out._set_error(error.coordinators_changed("majority unreachable"))
                return
            replies.append(f.get())
            if len(replies) >= self._majority:
                out._set(None)

        for f in futures:
            f.on_ready(one)
        await out
        return replies

    async def read(self) -> Optional[DBCoreState]:
        """Loop until our read generation exceeds every generation any
        majority coordinator has seen (reference: CoordinatedState::read
        retries on conflictGen). Without the loop, a fresh reader's
        first-guess generation competes on the random salt against the
        accumulated history and its write can lose forever — live-locking
        recovery behind master churn."""
        while True:
            gen = Generation(self._max_seen.txn + 1, self.salt)
            replies = await self._broadcast(
                GENERATION_READ_TOKEN, lambda _: GenerationReadRequest(CSTATE_KEY, gen)
            )
            value, value_gen = None, ZERO_GEN
            stale = False
            for r in replies:
                if r.value_gen >= value_gen:
                    value, value_gen = r.value, r.value_gen
                if r.read_gen > self._max_seen:
                    self._max_seen = r.read_gen
                if r.read_gen > gen:
                    stale = True   # someone is ahead: our write would lose
            if stale:
                continue
            self._read_gen = gen
            self._write_gen = gen
            return value

    async def set_exclusive(self, state: DBCoreState) -> None:
        """Write `state`; any interleaved reader/writer with a higher
        generation wins and we die (coordinated_state_conflict semantics
        via master_recovery_failed).

        The first write uses the read generation exactly (the register's
        `gen >= read_gen` check is the exclusivity gate). Every LATER write
        runs a fresh read-verify-write cycle (the reference's
        ReusableCoordinatedState shape): the fresh read yields a strictly
        higher generation — ordering this write after our own earlier ones
        even when a delayed duplicate frame lands late on one register —
        and verifies the value is still our last write, so an interleaved
        writer is detected rather than silently overwritten (a bare
        txn+1 bump would pass the register check on a salt tie and let two
        masters both believe they hold exclusivity)."""
        async with self._write_mutex:
            assert self._write_gen is not None, "read() before set_exclusive()"
            if self._last_written is not None:
                cur = await self.read()
                if cur != self._last_written:
                    raise error.master_recovery_failed(
                        "cstate changed under this master between writes"
                    )
            gen = self._write_gen
            replies = await self._broadcast(
                GENERATION_WRITE_TOKEN,
                lambda _: GenerationWriteRequest(CSTATE_KEY, gen, state),
            )
            for r in replies:
                if not r.ok:
                    raise error.master_recovery_failed(
                        f"cstate write lost to generation {r.max_gen}"
                    )
            if gen > self._max_seen:
                self._max_seen = gen
            self._last_written = state


from ..core import wire as _wire

_wire.register_record(LogGenerationInfo)
_wire.register_record(DBCoreState)
