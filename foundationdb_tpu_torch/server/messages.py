"""Typed request/reply payloads between roles.

Port of ``foundationdb_tpu/server/messages.py``.

Analogs of the reference's *Interface.h structs (MasterProxyInterface.h,
ResolverInterface.h:83-98, TLogInterface.h, StorageServerInterface.h). The
sim network passes them by reference; roles must treat them as immutable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.types import CommitTransaction, Key, KeyRange, Mutation, Version

# -- master ------------------------------------------------------------------


@dataclass
class GetCommitVersionRequest:
    """reference: GetCommitVersionRequest (MasterInterface.h); requestNum
    dedups retried proxy requests."""

    request_num: int
    proxy_id: str


@dataclass
class GetCommitVersionReply:
    version: Version
    prev_version: Version
    #: live resolutionBalancing (masterserver.actor.cpp:919-977 redesigned
    #: bounce-free): when set, every batch with version >= routing_version
    #: must split conflict ranges by routing_splits (the new resolver map);
    #: the master piggybacks the CURRENT flip on every reply, proxies apply
    #: it before building their batch (phase 1 orders it exactly)
    routing_version: Version = 0
    routing_old_splits: tuple = ()
    routing_splits: tuple = ()


# -- resolver ----------------------------------------------------------------


@dataclass
class ResolveTransactionBatchRequest:
    """reference: ResolverInterface.h:83-98."""

    prev_version: Version
    version: Version
    last_received_version: Version
    transactions: List[CommitTransaction] = field(default_factory=list)
    #: live split handoff (ResolutionSplitRequest's role): batches at or
    #: above routing_version were split by the NEW resolver map; on first
    #: sight (the version chain orders it), the resolver seeds a synthetic
    #: whole-span write over the ranges it GAINED, so reads with pre-flip
    #: snapshots conflict conservatively instead of silently missing the
    #: donor's history (exact again once snapshots pass the flip)
    routing_version: Version = 0
    routing_old_splits: tuple = ()
    routing_splits: tuple = ()


@dataclass
class ResolveTransactionBatchReply:
    committed: List[int] = field(default_factory=list)  # TransactionCommitResult values


# -- tlog --------------------------------------------------------------------


@dataclass
class TLogCommitRequest:
    """reference: TLogCommitRequest (TLogInterface.h); messages are
    (tag -> mutations) for one commit version. gen_id scopes the push to
    one log generation; known_committed is the proxy's newest all-replica-
    acked version (the KCV the peek horizon rides on)."""

    prev_version: Version
    version: Version
    messages: Dict[int, List[Mutation]] = field(default_factory=dict)
    gen_id: Tuple[int, int] = (0, 0)
    known_committed: Version = 0


@dataclass
class TLogKnownCommittedRequest:
    """All replicas acked `version`; advance the peek horizon."""

    version: Version


@dataclass
class TLogLockRequest:
    """End this generation (reference: TLogLockResult via tLogLock:496)."""

    pass


@dataclass
class TLogLockReply:
    gen_id: Tuple[int, int]
    known_committed: Version
    end_version: Version


@dataclass
class TLogRecoveryDataRequest:
    """Fetch all un-popped data <= end_version for seeding the successor
    generation."""

    end_version: Version


@dataclass
class TLogRecoveryDataReply:
    tag_data: Dict[int, List[Tuple[Version, List[Mutation]]]] = field(default_factory=dict)
    popped: Dict[int, Version] = field(default_factory=dict)


@dataclass
class TLogPeekRequest:
    """Pull messages for one tag from begin_version on; blocks until the
    tlog's version advances past begin_version (reference: tLogPeekMessages,
    TLogServer.actor.cpp:950)."""

    tag: int
    begin_version: Version


@dataclass
class TLogPeekReply:
    messages: List[Tuple[Version, List[Mutation]]] = field(default_factory=list)
    end_version: Version = 0   # peeker may advance its version to this


@dataclass
class TLogPopRequest:
    """Storage persisted through `version`; tlog may discard (tLogPop:898)."""

    tag: int
    version: Version


# -- proxy -------------------------------------------------------------------


@dataclass
class GetReadVersionRequest:
    """reference: GetReadVersionRequest (MasterProxyInterface.h)."""

    priority: int = 0


@dataclass
class GetReadVersionReply:
    version: Version


@dataclass
class CommitTransactionRequest:
    transaction: CommitTransaction
    #: multi-tenant QoS identity (docs/real_cluster.md): None rides the
    #: legacy single-tenant path untouched; set, the proxy's per-tenant
    #: admission control (server/ratekeeper.py TenantAdmission) may shed
    #: this commit with the typed transaction_throttled error instead of
    #: letting one hot tenant queue every other tenant past the SLO
    tenant: Optional[str] = None


@dataclass
class CommitReply:
    """version set on success; error raised otherwise (not_committed /
    transaction_too_old propagate as FDBError through the sim network).
    txn_batch_index orders transactions that share a commit version
    (reference: CommitID's batchIndex, used by versionstamps)."""

    version: Version
    txn_batch_index: int = 0


@dataclass
class GetKeyServerLocationsRequest:
    begin: Key
    end: Key


@dataclass
class GetKeyServerLocationsReply:
    """(range, [storage addresses]) pairs covering [begin, end)."""

    results: List[Tuple[KeyRange, List[str]]] = field(default_factory=list)


# -- storage -----------------------------------------------------------------


@dataclass
class GetValueRequest:
    key: Key
    version: Version


@dataclass
class GetValueReply:
    value: Optional[bytes]


@dataclass
class WatchValueRequest:
    """Fires when key's value differs from `value` (watchValue:773)."""

    key: Key
    value: Optional[bytes]
    version: Version


@dataclass
class GetKeyValuesRequest:
    """Range read [begin, end) at version, up to `limit` pairs
    (reference: GetKeyValuesRequest, StorageServerInterface.h)."""

    begin: Key
    end: Key
    version: Version
    limit: int = 10_000
    reverse: bool = False


@dataclass
class GetKeyValuesReply:
    data: List[Tuple[Key, bytes]] = field(default_factory=list)
    more: bool = False

