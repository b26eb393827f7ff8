"""Coordinators: replicated generation registers + leader registers.

Port of ``foundationdb_tpu/server/coordination.py``.

Re-design of fdbserver/Coordination.actor.cpp. Each coordinator process
hosts

  * a GenerationReg (localGenerationReg:125): a (read_gen, write_gen, value)
    register implementing the disk-paxos-style coordinated state. Reads
    advance read_gen; writes commit only if their generation is >= both
    generations seen so far. A majority of coordinators therefore
    linearizes DBCoreState updates: two would-be masters racing on the
    same generation cannot both win a majority.
  * a LeaderRegister (leaderRegister:203): candidates register themselves;
    the register nominates the best live candidate and forgets a leader
    whose heartbeats stop. Majority agreement on one nominee elects the
    cluster controller (LeaderElection.actor.cpp:78).

State lives in proc.globals so a REBOOT kill preserves it (the disk) while
KILL_INSTANTLY + REBOOT_AND_DELETE clears it — the durability seam until
the sim-disk round replaces globals with files.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core import buggify, error, wire
from ..sim.loop import Promise, TaskPriority, delay, now, spawn
from ..sim.network import Endpoint, SimProcess

GENERATION_READ_TOKEN = "coord.genRead"
GENERATION_WRITE_TOKEN = "coord.genWrite"
CANDIDACY_TOKEN = "coord.candidacy"
LEADER_HEARTBEAT_TOKEN = "coord.leaderHeartbeat"
GET_LEADER_TOKEN = "coord.getLeader"

#: a nominated leader is forgotten this long after its last heartbeat
#: (reference: POLLING_FREQUENCY/timeout in leaderRegister)
LEADER_TIMEOUT = 2.0
#: candidates re-submit at least this often; registrations expire after 2x
CANDIDACY_TTL = 2.0


@dataclass(frozen=True, order=True)
class Generation:
    """Lexicographic (txn, salt) generation id (reference: UniqueGeneration,
    CoordinatedState: higher txn wins; salt breaks ties uniquely)."""

    txn: int = 0
    salt: int = 0


ZERO_GEN = Generation(0, 0)


@dataclass(frozen=True)
class LeaderInfo:
    """A candidate for cluster controllership (reference: LeaderInfo,
    CoordinationInterface.h). Lower (priority, id) is better."""

    address: str
    id: int
    priority: int = 0

    def better_than(self, other: "LeaderInfo") -> bool:
        return (self.priority, self.id) < (other.priority, other.id)


# -- wire types ---------------------------------------------------------------


@dataclass
class GenerationReadRequest:
    key: str
    gen: Generation


@dataclass
class GenerationReadReply:
    value: Any
    value_gen: Generation      # generation at which value was written
    read_gen: Generation       # max generation this register has seen


@dataclass
class GenerationWriteRequest:
    key: str
    gen: Generation
    value: Any


@dataclass
class GenerationWriteReply:
    ok: bool
    max_gen: Generation        # on rejection: the competing generation seen


@dataclass
class CandidacyRequest:
    info: LeaderInfo
    prev_nominee_id: Optional[int] = None   # long-poll: reply when different


@dataclass
class LeaderHeartbeatRequest:
    info: LeaderInfo


@dataclass
class GetLeaderRequest:
    prev_nominee_id: Optional[int] = None   # long-poll: reply when different


class _GenerationReg:
    def __init__(self) -> None:
        self.read_gen: Generation = ZERO_GEN
        self.write_gen: Generation = ZERO_GEN
        self.value: Any = None

    def read(self, gen: Generation) -> GenerationReadReply:
        if gen > self.read_gen:
            self.read_gen = gen
        return GenerationReadReply(self.value, self.write_gen, self.read_gen)

    def write(self, gen: Generation, value: Any) -> GenerationWriteReply:
        if gen >= self.read_gen and gen >= self.write_gen:
            self.write_gen = gen
            self.value = value
            return GenerationWriteReply(True, gen)
        return GenerationWriteReply(False, max(self.read_gen, self.write_gen))


class _LeaderRegister:
    def __init__(self) -> None:
        #: candidate id -> (info, registration deadline)
        self.candidates: Dict[int, Tuple[LeaderInfo, float]] = {}
        self.nominee: Optional[LeaderInfo] = None
        self.lease_until: float = 0.0
        self._watchers: List[Tuple[Optional[int], Promise]] = []

    def _best_candidate(self, t: float) -> Optional[LeaderInfo]:
        live = [info for info, dl in self.candidates.values() if dl > t]
        if not live:
            return None
        best = live[0]
        for c in live[1:]:
            if c.better_than(best):
                best = c
        return best

    def refresh(self, t: float) -> None:
        """Drop an expired leader and (re)nominate the best live candidate.
        A strictly better candidate preempts the incumbent (the reference's
        leaderRegister re-nominates on every candidacy; the deposed leader
        notices via failing heartbeats and abdicates)."""
        if self.nominee is not None and self.lease_until <= t:
            self.nominee = None
        best = self._best_candidate(t)
        if best is not None and (self.nominee is None or best.better_than(self.nominee)):
            self.nominee = best
            self.lease_until = t + LEADER_TIMEOUT
        self._notify()

    def _notify(self) -> None:
        nid = self.nominee.id if self.nominee is not None else None
        still = []
        for prev, p in self._watchers:
            if prev != nid:
                p.send(self.nominee)
            else:
                still.append((prev, p))
        self._watchers = still

    def wait_nominee(self, prev_id: Optional[int]) -> Promise:
        p = Promise()
        nid = self.nominee.id if self.nominee is not None else None
        if nid != prev_id:
            p.send(self.nominee)
        else:
            self._watchers.append((prev_id, p))
        return p

    def drop_watch(self, p: Promise) -> None:
        """Forget a long-poll watcher whose request timed out, so abandoned
        polls don't accumulate across a long simulation."""
        self._watchers = [(prev, w) for (prev, w) in self._watchers if w is not p]


class CoordinationServer:
    """One coordinator process's servables (coordinationServer:413).

    With a disk, generation registers are durable: every promise (read_gen
    advance) and accept (write) is fsynced BEFORE the reply — the register
    must never forget a promise it answered, or a rebooted coordinator
    could accept a write its quorum already rejected (OnDemandStore,
    Coordination.actor.cpp:86). Without a disk, registers live in
    proc.globals (kept for protocol-level tests)."""

    def __init__(self, proc: SimProcess, disk=None, regs=None):
        self.proc = proc
        self.disk = disk
        if regs is not None:
            self.regs = regs
        elif disk is None:
            self.regs: Dict[str, _GenerationReg] = proc.globals.setdefault("coord.regs", {})
        else:
            self.regs = {}
        from ..sim.actors import AsyncMutex

        #: serializes register persists: interleaved write/sync cycles could
        #: make an OLDER snapshot durable after a newer acked one
        self._persist_mutex = AsyncMutex()
        self.leader = _LeaderRegister()   # leadership is NOT durable state
        proc.register(GENERATION_READ_TOKEN, self._gen_read)
        proc.register(GENERATION_WRITE_TOKEN, self._gen_write)
        proc.register(CANDIDACY_TOKEN, self._candidacy)
        proc.register(LEADER_HEARTBEAT_TOKEN, self._heartbeat)
        proc.register(GET_LEADER_TOKEN, self._get_leader)
        proc.actors.add(spawn(self._sweeper(), TaskPriority.COORDINATION, name="coordSweep"))

    @classmethod
    async def create(cls, proc: SimProcess, disk) -> "CoordinationServer":
        """Boot-time constructor restoring durable registers from disk.
        State is read BEFORE any handler registers: a request served in the
        restore window must never see an empty register (the promise would
        be forgotten)."""
        regs: Dict[str, _GenerationReg] = {}
        f = disk.open("coord.regs")
        raw = await f.read(0, f.size())
        if raw:
            try:
                for key, (rg, wg, value) in wire.loads(raw).items():
                    reg = _GenerationReg()
                    reg.read_gen, reg.write_gen, reg.value = rg, wg, value
                    regs[key] = reg
            except Exception:
                pass  # torn register file: recovered as empty (first boot)
        return cls(proc, disk=disk, regs=regs)

    def _reg(self, key: str) -> _GenerationReg:
        r = self.regs.get(key)
        if r is None:
            r = self.regs[key] = _GenerationReg()
        return r

    async def _persist_regs(self) -> None:
        """Durable register snapshot, crash-safe and serialized: the
        snapshot is taken under the persist lock (no older in-flight
        snapshot can land after a newer acked one) and written to a fresh
        file + rename (an in-place rewrite torn mid-crash would erase
        previously synced promises)."""
        if self.disk is None:
            return
        if buggify.buggify():
            # stretch the window between answering and persisting races
            await delay(0.05, TaskPriority.COORDINATION)
        async with self._persist_mutex:
            payload = wire.dumps({
                k: (r.read_gen, r.write_gen, r.value) for k, r in self.regs.items()
            })
            tmp = self.disk.open("coord.regs.tmp")
            await tmp.truncate(0)
            await tmp.write(0, payload)
            await tmp.sync()
            self.disk.rename("coord.regs.tmp", "coord.regs")

    async def _gen_read(self, req: GenerationReadRequest) -> GenerationReadReply:
        reg = self._reg(req.key)
        before = reg.read_gen
        reply = reg.read(req.gen)
        if reg.read_gen != before:
            # The promise must be durable before it is given.
            await self._persist_regs()
        return reply

    async def _gen_write(self, req: GenerationWriteRequest) -> GenerationWriteReply:
        if buggify.buggify():
            # reorder writes against competing masters' broadcasts: the
            # exclusive-write generation check must still pick one winner
            await delay(0.05, TaskPriority.COORDINATION)
        reply = self._reg(req.key).write(req.gen, req.value)
        if reply.ok:
            await self._persist_regs()
        return reply

    async def _candidacy(self, req: CandidacyRequest) -> Optional[LeaderInfo]:
        t = now()
        self.leader.candidates[req.info.id] = (req.info, t + 2 * CANDIDACY_TTL)
        self.leader.refresh(t)
        # Long-poll: reply with the nominee once it differs from what the
        # candidate last saw (bounded so re-registration keeps flowing).
        p = self.leader.wait_nominee(req.prev_nominee_id)
        await _first(p.future, delay(CANDIDACY_TTL, TaskPriority.COORDINATION))
        self.leader.drop_watch(p)
        return self.leader.nominee

    async def _heartbeat(self, req: LeaderHeartbeatRequest) -> bool:
        t = now()
        self.leader.candidates[req.info.id] = (req.info, t + 2 * CANDIDACY_TTL)
        if self.leader.nominee is not None and self.leader.nominee.id == req.info.id:
            self.leader.lease_until = t + LEADER_TIMEOUT
            return True
        self.leader.refresh(t)
        return self.leader.nominee is not None and self.leader.nominee.id == req.info.id

    async def _get_leader(self, req: GetLeaderRequest) -> Optional[LeaderInfo]:
        p = self.leader.wait_nominee(req.prev_nominee_id)
        await _first(p.future, delay(LEADER_TIMEOUT, TaskPriority.COORDINATION))
        self.leader.drop_watch(p)
        return self.leader.nominee

    async def _sweeper(self) -> None:
        """Expire silent leaders even with no request traffic."""
        while True:
            tick = LEADER_TIMEOUT / 2
            if buggify.buggify():
                # eager sweeper: leases expire at the earliest legal moment,
                # so heartbeat renewal races the sweep
                tick = LEADER_TIMEOUT / 16
            await delay(tick, TaskPriority.COORDINATION)
            self.leader.refresh(now())


async def _first(a, b):
    """Wait until either future resolves (errors propagate)."""
    from ..sim.actors import any_of

    await any_of([a, b])


wire.register_record(Generation)
