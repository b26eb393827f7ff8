"""KeyRangeMap: a coalescing range-keyed map.

Port of ``foundationdb_tpu/core/keyrangemap.py``.

Re-design of fdbclient/KeyRangeMap.h (+ flow/IndexedSet.h's role as its
container): the WHOLE keyspace is covered by contiguous half-open ranges,
each carrying a value; `insert` overwrites a span (splitting boundary
ranges), point and range lookups are bisects, and adjacent ranges with
equal values COALESCE — the property the reference leans on for the
keyServers/serverKeys maps, the client's location cache, and conflict-
range bookkeeping.

Representation: ascending boundary keys with `vals[i]` covering
[bounds[i], bounds[i+1]) and vals[-1] covering [bounds[-1], +inf)."""
from __future__ import annotations

import bisect
from typing import Any, Iterator, List, Optional, Tuple


class KeyRangeMap:
    def __init__(self, default: Any = None):
        self._bounds: List[bytes] = [b""]
        self._vals: List[Any] = [default]

    # -- lookups --------------------------------------------------------------
    def _idx(self, key: bytes) -> int:
        return bisect.bisect_right(self._bounds, key) - 1

    def __getitem__(self, key: bytes) -> Any:
        return self._vals[self._idx(key)]

    def range_containing(self, key: bytes) -> Tuple[bytes, Optional[bytes], Any]:
        """(begin, end, value) of the range holding `key`; end is None for
        the final (unbounded) range."""
        i = self._idx(key)
        end = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
        return self._bounds[i], end, self._vals[i]

    def intersecting(self, begin: bytes, end: bytes
                     ) -> Iterator[Tuple[bytes, Optional[bytes], Any]]:
        """Every (clipped_begin, clipped_end, value) covering [begin, end)."""
        if begin >= end:
            return
        i = self._idx(begin)
        while i < len(self._bounds):
            b = self._bounds[i]
            if b >= end:
                return
            e = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
            cb = max(b, begin)
            ce = end if e is None else min(e, end)
            yield cb, ce, self._vals[i]
            i += 1

    def ranges(self) -> List[Tuple[bytes, Optional[bytes], Any]]:
        out = []
        for i, b in enumerate(self._bounds):
            e = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
            out.append((b, e, self._vals[i]))
        return out

    # -- mutation -------------------------------------------------------------
    def insert(self, begin: bytes, end: Optional[bytes], value: Any) -> None:
        """Set [begin, end) (end None = to +inf) to `value`, splitting the
        boundary ranges and coalescing equal neighbors."""
        if end is not None and begin >= end:
            return
        i = self._idx(begin)
        # value that resumes after `end`
        after_val = self._vals[self._idx(end)] if end is not None else None
        # drop boundaries strictly inside (begin, end)
        if end is None:
            hi = len(self._bounds)
        else:
            hi = bisect.bisect_left(self._bounds, end)
        lo = i + 1
        del self._bounds[lo:hi]
        del self._vals[lo:hi]
        # split at begin
        if self._bounds[i] == begin:
            self._vals[i] = value
        else:
            self._bounds.insert(i + 1, begin)
            self._vals.insert(i + 1, value)
            i += 1
        # split at end (restore the suffix value)
        if end is not None:
            nxt = self._bounds[i + 1] if i + 1 < len(self._bounds) else None
            if nxt != end:
                self._bounds.insert(i + 1, end)
                self._vals.insert(i + 1, after_val)
        self._coalesce_around(i)

    def _coalesce_around(self, i: int) -> None:
        """Merge range i with equal-valued neighbors (KeyRangeMap's
        coalesce): the map stays minimal."""
        # right neighbor first (indices shift left on delete)
        if i + 1 < len(self._bounds) and self._vals[i + 1] == self._vals[i]:
            del self._bounds[i + 1]
            del self._vals[i + 1]
        if i > 0 and self._vals[i - 1] == self._vals[i]:
            del self._bounds[i]
            del self._vals[i]

    def clear(self, default: Any = None) -> None:
        self._bounds = [b""]
        self._vals = [default]

    def __len__(self) -> int:
        return len(self._bounds)
