"""Core value types of the framework.

Port of ``foundationdb_tpu/core/types.py``: keys, versions, ranges,
mutations, the versionstamp helpers, the atomic-op evaluator and the
commit transaction, with the same wire record names, so a transaction
dumps to the same bytes in both packages.

Keys are plain ``bytes`` ordered bytewise (shorter-is-less on equal prefix),
exactly the ordering of the reference comparator (fdbserver/SkipList.cpp:113-120).
Versions are int64, advancing ~1e6 per wall-clock second like the reference
master's version authority (fdbserver/masterserver.actor.cpp:786).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Version = int  # int64 semantics
Key = bytes
Value = bytes

INVALID_VERSION: Version = -1
MAX_VERSION: Version = (1 << 62)

#: Versions per wall-clock second handed out by the version authority
#: (reference: VERSIONS_PER_SECOND, fdbserver/Knobs.cpp).
VERSIONS_PER_SECOND: int = 1_000_000

#: The MVCC / conflict-detection window: 5 seconds of versions
#: (reference: MAX_WRITE_TRANSACTION_LIFE_VERSIONS, fdbserver/Knobs.cpp).
MAX_WRITE_TRANSACTION_LIFE_VERSIONS: int = 5 * VERSIONS_PER_SECOND

#: End of the user keyspace; system keys live in [SYSTEM_KEY_PREFIX, \xff\xff).
USER_KEY_END: Key = b"\xff"
SYSTEM_KEY_PREFIX: Key = b"\xff"


def is_point_range(begin: Key, end: Key) -> bool:
    """True iff the half-open range is exactly [k, k+'\\x00') — the conflict
    kernel's cheap POINT row shape (its end key is synthesized on device).
    The single definition shared by the wire encoder and the host router."""
    return len(end) == len(begin) + 1 and end[-1] == 0 and end[:-1] == begin


def key_after(key: Key) -> Key:
    """Smallest key strictly greater than ``key`` (reference: keyAfter, FDBTypes.h)."""
    return key + b"\x00"


def strinc(key: Key) -> Key:
    """Smallest key strictly greater than every key having ``key`` as a prefix
    (reference: strinc, fdbclient/NativeAPI / flow)."""
    k = key.rstrip(b"\xff")
    if not k:
        raise ValueError("strinc of all-\\xff key has no finite answer")
    return k[:-1] + bytes([k[-1] + 1])


@dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open key range [begin, end). Empty when begin >= end."""

    begin: Key
    end: Key

    def __post_init__(self) -> None:
        if not (isinstance(self.begin, bytes) and isinstance(self.end, bytes)):
            raise TypeError("KeyRange endpoints must be bytes")

    @property
    def empty(self) -> bool:
        return self.begin >= self.end

    def contains(self, key: Key) -> bool:
        return self.begin <= key < self.end

    def intersects(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def intersection(self, other: "KeyRange") -> "KeyRange":
        return KeyRange(max(self.begin, other.begin), min(self.end, other.end))


def single_key_range(key: Key) -> KeyRange:
    return KeyRange(key, key_after(key))


ALL_KEYS = KeyRange(b"", b"\xff\xff")


class MutationType(enum.IntEnum):
    """Mutation opcodes (reference: MutationRef::Type, fdbclient/CommitTransaction.h:31)."""

    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD_VALUE = 2
    DEBUG_KEY_RANGE = 3
    DEBUG_KEY = 4
    NO_OP = 5
    AND = 6
    OR = 7
    XOR = 8
    APPEND_IF_FITS = 9
    AVAILABLE_FOR_REUSE = 10
    RESERVED_FOR_LOG_PROTOCOL_MESSAGE = 11
    MAX = 12
    MIN = 13
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15
    BYTE_MIN = 16
    BYTE_MAX = 17
    MIN_V2 = 18
    AND_V2 = 19


ATOMIC_MUTATIONS = frozenset(
    {
        MutationType.ADD_VALUE,
        MutationType.AND,
        MutationType.OR,
        MutationType.XOR,
        MutationType.APPEND_IF_FITS,
        MutationType.MAX,
        MutationType.MIN,
        MutationType.SET_VERSIONSTAMPED_KEY,
        MutationType.SET_VERSIONSTAMPED_VALUE,
        MutationType.BYTE_MIN,
        MutationType.BYTE_MAX,
        MutationType.MIN_V2,
        MutationType.AND_V2,
    }
)

SINGLE_KEY_MUTATIONS = ATOMIC_MUTATIONS | {MutationType.SET_VALUE}

#: Mutations the proxy rewrites into SET_VALUE at commit time; storage
#: servers must never see them (fdbclient/Atomic.h:258-271).
VERSIONSTAMP_MUTATIONS = frozenset(
    {MutationType.SET_VERSIONSTAMPED_KEY, MutationType.SET_VERSIONSTAMPED_VALUE}
)

#: Atomic ops evaluable at a storage server (everything except versionstamps).
STORAGE_ATOMIC_MUTATIONS = ATOMIC_MUTATIONS - VERSIONSTAMP_MUTATIONS

VERSIONSTAMP_SIZE = 10


def place_versionstamp(version: Version, batch_index: int) -> bytes:
    """The 10-byte versionstamp: 8-byte big-endian commit version + 2-byte
    big-endian transaction number within the batch (reference:
    placeVersionstamp, fdbclient/Atomic.h:250-256)."""
    return version.to_bytes(8, "big") + (batch_index & 0xFFFF).to_bytes(2, "big")


def validate_versionstamp_param(param: bytes) -> bool:
    """True iff a SET_VERSIONSTAMPED_* param is well-formed: a trailing
    little-endian int32 naming a stamp position fully inside the remaining
    bytes (reference: the client rejects bad offsets in
    ReadYourWrites.actor.cpp before the mutation ever reaches a proxy)."""
    if len(param) < 4 + VERSIONSTAMP_SIZE:
        return False
    pos = int.from_bytes(param[-4:], "little", signed=True)
    return 0 <= pos and pos + VERSIONSTAMP_SIZE <= len(param) - 4


def transform_versionstamp_mutation(m: "Mutation", version: Version, batch_index: int) -> "Mutation":
    """Rewrite a SET_VERSIONSTAMPED_{KEY,VALUE} mutation into a plain
    SET_VALUE with the stamp substituted, at the position named by the
    little-endian int32 trailing the stamped param (reference:
    transformVersionstampMutation, fdbclient/Atomic.h:258-271; applied by the
    proxy at MasterProxyServer.actor.cpp:270-275)."""
    stamped_key = m.type == MutationType.SET_VERSIONSTAMPED_KEY
    param = m.param1 if stamped_key else m.param2
    if len(param) >= 4:
        pos = int.from_bytes(param[-4:], "little", signed=True)
        param = param[:-4]
        if 0 <= pos and pos + VERSIONSTAMP_SIZE <= len(param):
            stamp = place_versionstamp(version, batch_index)
            param = param[:pos] + stamp + param[pos + VERSIONSTAMP_SIZE:]
    if stamped_key:
        return Mutation(MutationType.SET_VALUE, param, m.param2)
    return Mutation(MutationType.SET_VALUE, m.param1, param)


@dataclass(frozen=True)
class Mutation:
    """One mutation: (type, param1, param2) — param1 is the key (or range begin),
    param2 the value (or range end)."""

    type: MutationType
    param1: bytes
    param2: bytes

    def expected_size(self) -> int:
        return len(self.param1) + len(self.param2)


@dataclass
class CommitTransaction:
    """Wire form of a transaction submitted for commit
    (reference: CommitTransactionRef, fdbclient/CommitTransaction.h:89-121)."""

    read_conflict_ranges: List[KeyRange] = field(default_factory=list)
    write_conflict_ranges: List[KeyRange] = field(default_factory=list)
    mutations: List[Mutation] = field(default_factory=list)
    read_snapshot: Version = 0
    #: commits through a database lock (the LOCK_AWARE transaction option;
    #: management/DR transactions set it — reference: lockDatabase,
    #: fdbclient/ManagementAPI.actor.cpp)
    lock_aware: bool = False

    def set(self, key: Key, value: Value) -> None:
        self.mutations.append(Mutation(MutationType.SET_VALUE, key, value))
        self.write_conflict_ranges.append(single_key_range(key))

    def clear(self, rng: KeyRange) -> None:
        self.mutations.append(Mutation(MutationType.CLEAR_RANGE, rng.begin, rng.end))
        self.write_conflict_ranges.append(rng)

    def atomic_op(self, key: Key, value: Value, op: MutationType) -> None:
        if op not in ATOMIC_MUTATIONS:
            raise ValueError(f"not an atomic op: {op}")
        self.mutations.append(Mutation(op, key, value))
        self.write_conflict_ranges.append(single_key_range(key))

    def expected_size(self) -> int:
        n = sum(len(r.begin) + len(r.end) for r in self.read_conflict_ranges)
        n += sum(len(r.begin) + len(r.end) for r in self.write_conflict_ranges)
        n += sum(m.expected_size() for m in self.mutations)
        return n

    def conflict_wire_info(self) -> Tuple[bytes, bool, int]:
        """This transaction's conflict ranges as one columnar wire block
        (core/wire.py) plus (all_point, max_key_len) classification computed
        during the encode. Client-side work, cached against the range tuples
        themselves (tuple compare is identity-shortcut pointer checks, so a
        cache hit is O(ranges) pointer compares — in-place range replacement
        invalidates correctly)."""
        from . import wire

        key = (tuple(self.read_conflict_ranges), tuple(self.write_conflict_ranges))
        cached = getattr(self, "_wire_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        info = wire.conflict_wire_ex(key[0], key[1])
        self._wire_cache = (key, info)
        return info

    def conflict_wire_block(self) -> bytes:
        return self.conflict_wire_info()[0]


class TransactionCommitResult(enum.IntEnum):
    """Per-transaction resolution verdict (reference: ConflictSet.h:36-40).

    The integer values are load-bearing: the proxy combines votes from all
    touched resolver shards with ``min`` (MasterProxyServer.actor.cpp:489-500),
    so CONFLICT < TOO_OLD < COMMITTED must hold.
    """

    CONFLICT = 0
    TOO_OLD = 1
    COMMITTED = 2


#: reference: CLIENT_KNOBS->VALUE_SIZE_LIMIT (fdbclient/Knobs.cpp:56)
VALUE_SIZE_LIMIT: int = 100_000


def apply_atomic_op(op: MutationType, existing: Optional[Value], param: Value) -> Value:
    """Pure atomic-op evaluation applied at storage servers — reference-exact
    (fdbclient/Atomic.h). Except for APPEND_IF_FITS and the BYTE_* winners,
    the result always has len(param): the existing value is implicitly
    truncated/zero-extended to the operand's width ("the window")."""
    old = existing if existing is not None else b""
    n = len(param)
    m = min(len(old), n)

    def old_window() -> Value:
        # existing truncated to len(param) and zero-extended (doMax/doMin's
        # copy loops, Atomic.h:146-155,176-199).
        return old[:n] + b"\x00" * (n - m)

    if op == MutationType.ADD_VALUE:
        # doLittleEndianAdd (Atomic.h:27-48): carry propagates through all of
        # param's bytes; result is len(param).
        if not old or not param:
            return param
        a = int.from_bytes(old[:n], "little")
        b = int.from_bytes(param, "little")
        return ((a + b) & ((1 << (8 * n)) - 1)).to_bytes(n, "little")
    if op in (MutationType.AND, MutationType.AND_V2):
        # doAnd (Atomic.h:50-63): bytes beyond the existing value are 0; an
        # absent/empty existing value yields all-zeros. V2 (Atomic.h:65-70)
        # returns param when the key is missing.
        if op == MutationType.AND_V2 and existing is None:
            return param
        if not param:
            return param
        return bytes(x & y for x, y in zip(old, param)) + b"\x00" * (n - m)
    if op == MutationType.OR:
        if not old or not param:
            return param
        return bytes(x | y for x, y in zip(old, param)) + param[m:]
    if op == MutationType.XOR:
        if not old or not param:
            return param
        return bytes(x ^ y for x, y in zip(old, param)) + param[m:]
    if op == MutationType.APPEND_IF_FITS:
        # doAppendIfFits (Atomic.h:107-126)
        if not old:
            return param
        if not param:
            return old
        return old + param if len(old) + len(param) <= VALUE_SIZE_LIMIT else old
    if op == MutationType.MAX:
        # doMax (Atomic.h:128-158): little-endian compare over param's width;
        # param wins ties; existing wins as its zero-extended window.
        if not old or not param:
            return param
        pw = int.from_bytes(param, "little")
        ow = int.from_bytes(old_window(), "little")
        return param if pw >= ow else old_window()
    if op == MutationType.BYTE_MAX:
        # doByteMax (Atomic.h:160-168): winner returned verbatim (full length).
        if existing is None:
            return param
        return old if old > param else param
    if op in (MutationType.MIN, MutationType.MIN_V2):
        # doMin (Atomic.h:170-213); V2 (Atomic.h:215-220) returns param when
        # the key is missing. An absent key in MIN behaves as zeros.
        if op == MutationType.MIN_V2 and existing is None:
            return param
        if not param:
            return param
        pw = int.from_bytes(param, "little")
        ow = int.from_bytes(old_window(), "little")
        return param if pw <= ow else old_window()
    if op == MutationType.BYTE_MIN:
        # doByteMin (Atomic.h:222-230)
        if existing is None:
            return param
        return old if old < param else param
    raise ValueError(f"not an atomic op: {op}")


# -- wire registration (core/wire.py named records for disk state) ----------
from . import wire as _wire  # noqa: E402

_wire.register_record(Mutation)
_wire.register_record(KeyRange)
# whole transactions ride the black-box journal's batch records
# (core/blackbox.py) — the differential-replay unit
_wire.register_record(CommitTransaction)
_wire.register_enum(MutationType)
