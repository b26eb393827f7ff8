"""Reference-exact conflict-resolution oracle (pure Python).

This is the *logical model* of the reference resolver's versioned skip list
(fdbserver/SkipList.cpp). The skip list's observable state is a
piecewise-constant map key -> Version ("the last write version of the
interval containing this key") plus a scalar oldestVersion; per-batch verdicts
{CONFLICT, TOO_OLD, COMMITTED} are a pure function of that model:

  1. too-old check at add time          (SkipList.cpp:985)
  2. reads vs. history                  (checkReadConflictRanges:1210)
  3. intra-batch sweep in index order   (checkIntraBatchConflicts:1133)
  4. write union of committed txns applied at version `now`
                                        (combineWriteConflictRanges:1320,
                                         mergeWriteConflictRanges:1260)
  5. oldestVersion advance + GC         (detectConflicts:1199-1206)

The oracle pins the device engine's outputs bit for bit. GC
(removeBefore:665) only changes the *representation* (merging sub-oldest
intervals), never query results, because any read that passes the too-old
gate has read_snapshot >= oldestVersion > every merged version; the oracle
therefore runs the reference's one-pass keep rule eagerly.

Edge semantics reproduced deliberately:
  * empty read range [b,b): the skip list's CheckMax (SkipList.cpp:773-835)
    degenerates to checking the interval strictly below b; we mirror that.
  * empty write ranges never change the map (they cancel out in
    combineWriteConflictRanges's active-count sweep).
  * a transaction with reads=[] is never too-old regardless of snapshot.

The engine's host long-key tier keeps its history in a VersionIntervalMap.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence

from ..core.types import CommitTransaction, Key, KeyRange, TransactionCommitResult, Version


class VersionIntervalMap:
    """Sorted boundary list: interval [keys[i], keys[i+1]) has version vers[i];
    the last interval extends to +inf. keys[0] is always b''."""

    __slots__ = ("keys", "vers")

    def __init__(self, version: Version = 0):
        self.keys: List[Key] = [b""]
        self.vers: List[Version] = [version]

    def __len__(self) -> int:
        return len(self.keys)

    def version_at(self, key: Key) -> Version:
        return self.vers[bisect.bisect_right(self.keys, key) - 1]

    def version_strictly_below(self, key: Key) -> Version:
        """Version of the interval owned by the last boundary < key."""
        i = bisect.bisect_left(self.keys, key) - 1
        return self.vers[max(i, 0)]

    def range_max(self, begin: Key, end: Key) -> Version:
        """Max version over intervals intersecting non-empty [begin, end)."""
        lo = bisect.bisect_right(self.keys, begin) - 1
        hi = bisect.bisect_left(self.keys, end)
        return max(self.vers[lo:hi])

    def write(self, begin: Key, end: Key, version: Version) -> None:
        """Set [begin, end) to version, preserving the value at end."""
        if begin >= end:
            return
        keys, vers = self.keys, self.vers
        v_end = vers[bisect.bisect_right(keys, end) - 1]
        lo = bisect.bisect_left(keys, begin)
        hi = bisect.bisect_left(keys, end)
        repl_k: List[Key] = [begin]
        repl_v: List[Version] = [version]
        if hi == len(keys) or keys[hi] != end:
            repl_k.append(end)
            repl_v.append(v_end)
        keys[lo:hi] = repl_k
        vers[lo:hi] = repl_v

    def gc(self, oldest: Version) -> None:
        """Reference keep rule (removeBefore, SkipList.cpp:686-698): boundary i
        survives iff its version or its *original* predecessor's version is
        >= oldest. Representation-only; queries are unchanged for any read
        that passes the too-old gate."""
        keys, vers = self.keys, self.vers
        n = len(keys)
        nk: List[Key] = [keys[0]]
        nv: List[Version] = [vers[0]]
        for i in range(1, n):
            if vers[i] >= oldest or vers[i - 1] >= oldest:
                nk.append(keys[i])
                nv.append(vers[i])
        self.keys, self.vers = nk, nv


def _overlaps(a: KeyRange, b: KeyRange) -> bool:
    return a.begin < b.end and b.begin < a.end


class OracleConflictEngine:
    """Pluggable engine implementing the reference ConflictSet semantics
    (fdbserver/ConflictSet.h:27-60): resolve one ordered batch at version
    `now`, advance the GC horizon to `new_oldest`."""

    name = "oracle"

    def __init__(self, initial_version: Version = 0):
        self.map = VersionIntervalMap(initial_version)
        self.oldest_version: Version = 0

    def clear(self, version: Version) -> None:
        """reference: clearConflictSet (SkipList.cpp:957-959)."""
        self.map = VersionIntervalMap(version)

    def resolve(
        self,
        transactions: Sequence[CommitTransaction],
        now: Version,
        new_oldest: Version,
    ) -> List[TransactionCommitResult]:
        n = len(transactions)
        too_old = [False] * n
        conflict = [False] * n

        for t, tr in enumerate(transactions):
            if tr.read_snapshot < self.oldest_version and tr.read_conflict_ranges:
                too_old[t] = True

        # Phase: reads vs. history
        for t, tr in enumerate(transactions):
            if too_old[t]:
                continue
            for r in tr.read_conflict_ranges:
                if r.begin >= r.end:
                    hit = self.map.version_strictly_below(r.begin) > tr.read_snapshot
                else:
                    hit = self.map.range_max(r.begin, r.end) > tr.read_snapshot
                if hit:
                    conflict[t] = True
                    break

        # Phase: intra-batch, strictly in submission order; earlier wins.
        written: List[KeyRange] = []
        for t, tr in enumerate(transactions):
            if conflict[t] or too_old[t]:
                continue
            hit = False
            for r in tr.read_conflict_ranges:
                # An empty read range never intra-conflicts: its begin point
                # sorts after its end point, so MiniConflictSet::any sees an
                # inverted index range and scans nothing (SkipList.cpp:1020-1025).
                if r.begin < r.end and any(_overlaps(r, w) for w in written):
                    hit = True
                    break
            if hit:
                conflict[t] = True
                continue
            for w in tr.write_conflict_ranges:
                if w.begin < w.end:
                    written.append(w)

        # Phase: apply committed writes at `now`
        for t, tr in enumerate(transactions):
            if conflict[t] or too_old[t]:
                continue
            for w in tr.write_conflict_ranges:
                self.map.write(w.begin, w.end, now)

        # Phase: advance horizon + GC
        if new_oldest > self.oldest_version:
            self.oldest_version = new_oldest
            self.map.gc(new_oldest)

        out: List[TransactionCommitResult] = []
        for t in range(n):
            if too_old[t]:
                out.append(TransactionCommitResult.TOO_OLD)
            elif conflict[t]:
                out.append(TransactionCommitResult.CONFLICT)
            else:
                out.append(TransactionCommitResult.COMMITTED)
        return out
