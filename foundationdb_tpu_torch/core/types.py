"""Value types of the conflict check.

Keys are plain ``bytes`` ordered bytewise (shorter-is-less on equal prefix),
the order of the reference comparator (fdbserver/SkipList.cpp:113-120).
Versions are int64.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Tuple

Version = int  # int64 semantics
Key = bytes


def is_point_range(begin: Key, end: Key) -> bool:
    """True iff the half-open range is exactly [k, k+'\\x00') — the conflict
    kernel's cheap POINT row shape (its end key is synthesized on device)."""
    return len(end) == len(begin) + 1 and end[-1] == 0 and end[:-1] == begin


@dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open key range [begin, end). Empty when begin >= end."""

    begin: Key
    end: Key

    def __post_init__(self) -> None:
        if not (isinstance(self.begin, bytes) and isinstance(self.end, bytes)):
            raise TypeError("KeyRange endpoints must be bytes")


@dataclass
class CommitTransaction:
    """The conflict-relevant fields of a transaction submitted for commit
    (reference: CommitTransactionRef, fdbclient/CommitTransaction.h:89-121).
    The engine reads only these three fields, so any object carrying them
    resolves the same way."""

    read_conflict_ranges: List[KeyRange] = field(default_factory=list)
    write_conflict_ranges: List[KeyRange] = field(default_factory=list)
    read_snapshot: Version = 0

    def conflict_wire_info(self) -> Tuple[bytes, bool, int]:
        """This transaction's conflict ranges as one columnar wire block
        (core/wire.py) plus the (all_point, max_key_len) classification of
        the encode. Cached against the range tuples themselves: a hit costs
        O(ranges) identity compares, and replacing a range in place
        invalidates it."""
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
    touched resolver shards with ``min``, so CONFLICT < TOO_OLD < COMMITTED."""

    CONFLICT = 0
    TOO_OLD = 1
    COMMITTED = 2
