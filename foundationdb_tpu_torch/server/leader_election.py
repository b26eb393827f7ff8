"""Leader election: candidacy against the coordinators' leader registers.

Port of ``foundationdb_tpu/server/leader_election.py``.

Re-design of fdbserver/LeaderElection.actor.cpp (tryBecomeLeaderInternal:78)
+ fdbclient/MonitorLeader.actor.cpp. A candidate registers with every
coordinator; each coordinator's register independently nominates the best
live candidate; whoever a majority nominates is the leader and keeps the
lease alive with heartbeats. Losing the heartbeat majority means stepping
down (the register will nominate a successor once the lease expires).
"""
from __future__ import annotations

from typing import List, Optional

from ..core import buggify, error
from ..sim.actors import AsyncVar, all_of, any_of
from ..sim.loop import Future, TaskPriority, delay, spawn
from ..sim.network import Endpoint
from .coordination import (
    CANDIDACY_TOKEN,
    CANDIDACY_TTL,
    GET_LEADER_TOKEN,
    LEADER_HEARTBEAT_TOKEN,
    LEADER_TIMEOUT,
    CandidacyRequest,
    GetLeaderRequest,
    LeaderHeartbeatRequest,
    LeaderInfo,
)

HEARTBEAT_INTERVAL = LEADER_TIMEOUT / 4


def _majority(n: int) -> int:
    return n // 2 + 1


async def try_become_leader(
    net, src_addr: str, coordinator_addrs: List[str], info: LeaderInfo
) -> None:
    """Returns when `info` has been elected by a majority of coordinators
    (reference: tryBecomeLeaderInternal). The caller must then run
    `hold_leadership` and abdicate when it returns."""
    nominees: List[Optional[LeaderInfo]] = [None] * len(coordinator_addrs)
    changed = AsyncVar(0)

    async def poll(i: int, addr: str) -> None:
        prev_id: Optional[int] = None
        while True:
            if buggify.buggify():
                # laggard candidate: this coordinator sees the candidacy
                # late — elections must survive stragglers and re-votes
                await delay(CANDIDACY_TTL, TaskPriority.COORDINATION)
            try:
                nominee = await net.request(
                    src_addr,
                    Endpoint(addr, CANDIDACY_TOKEN),
                    CandidacyRequest(info, prev_id),
                    TaskPriority.COORDINATION,
                    timeout=2 * CANDIDACY_TTL,
                )
            except error.FDBError:
                nominees[i] = None
                changed.set(changed.get() + 1)
                await delay(CANDIDACY_TTL / 2, TaskPriority.COORDINATION)
                prev_id = None
                continue
            nominees[i] = nominee
            prev_id = nominee.id if nominee is not None else None
            changed.set(changed.get() + 1)

    pollers = [
        spawn(poll(i, addr), TaskPriority.COORDINATION, name=f"candidacy:{addr}")
        for i, addr in enumerate(coordinator_addrs)
    ]
    try:
        while True:
            votes = sum(
                1 for n in nominees if n is not None and n.id == info.id
            )
            if votes >= _majority(len(coordinator_addrs)):
                return
            await changed.on_change()
    finally:
        for p in pollers:
            p.cancel()


async def hold_leadership(
    net, src_addr: str, coordinator_addrs: List[str], info: LeaderInfo
) -> None:
    """Heartbeat every coordinator; returns when a majority no longer
    acknowledges this leader (lease lost — abdicate NOW)."""
    while True:
        futures = [
            net.request(
                src_addr,
                Endpoint(addr, LEADER_HEARTBEAT_TOKEN),
                LeaderHeartbeatRequest(info),
                TaskPriority.COORDINATION,
                timeout=LEADER_TIMEOUT / 2,
            )
            for addr in coordinator_addrs
        ]
        acks = 0
        for f in futures:
            try:
                if await _settle(f):
                    acks += 1
            except error.FDBError:
                pass
        if acks < _majority(len(coordinator_addrs)):
            return
        interval = HEARTBEAT_INTERVAL
        if buggify.buggify():
            # near-miss heartbeat cadence: the lease renews just before
            # expiry, so coordinator-side TTL math gets exercised at the edge
            interval = LEADER_TIMEOUT * 0.9
        await delay(interval, TaskPriority.COORDINATION)


async def _settle(f: Future):
    return await f


async def tally_leader_once(net, src_addr: str, coordinator_addrs: List[str]
                            ) -> Optional[LeaderInfo]:
    """One majority nominee tally: the leader if a majority of coordinators
    currently agree on one, else None. Shared by monitor_leader and the
    client's cluster-file resolution."""
    tally: dict = {}
    for addr in coordinator_addrs:
        try:
            nominee = await net.request(
                src_addr, Endpoint(addr, GET_LEADER_TOKEN),
                GetLeaderRequest(None), TaskPriority.COORDINATION,
                timeout=LEADER_TIMEOUT,
            )
        except error.FDBError:
            continue
        if nominee is not None:
            count, _ = tally.get(nominee.id, (0, nominee))
            tally[nominee.id] = (count + 1, nominee)
    for count, nominee in tally.values():
        if count >= _majority(len(coordinator_addrs)):
            return nominee
    return None


async def monitor_leader(
    net, src_addr: str, coordinator_addrs: List[str], out: AsyncVar
) -> None:
    """Keep `out` set to the currently elected leader (or None), as seen by
    a majority of coordinators (reference: monitorLeaderInternal). Runs
    forever; spawn it on the observing process."""
    while True:
        best = await tally_leader_once(net, src_addr, coordinator_addrs)
        if (out.get().id if out.get() is not None else None) != (
            best.id if best is not None else None
        ):
            out.set(best)
        await delay(LEADER_TIMEOUT / 2, TaskPriority.COORDINATION)
