"""Static key-range shard map.

The analog of the proxy's `keyResolvers` range map
(MasterProxyServer.actor.cpp:263-316). The engine routes every row through
it; this slice runs one shard, so the map has no split keys, but the routing
code keeps the shape it takes once the keyspace is split.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from .types import Key


def _fmt_key(key: bytes) -> str:
    """Render a boundary key for humans/JSON: printable ASCII as text,
    anything else as 0x-hex."""
    try:
        s = key.decode()
        if s.isascii() and s.isprintable():
            return s
    except UnicodeDecodeError:
        pass
    return "0x" + key.hex()


class KeyShardMap:
    """Static partition of the keyspace into S contiguous spans.

    Span s = [begins[s], begins[s+1]) with begins[0] = b'' and a virtual
    +inf end for the last span."""

    def __init__(self, split_keys: Sequence[Key]):
        if list(split_keys) != sorted(split_keys):
            raise ValueError("split keys must be sorted")
        if not all(k for k in split_keys):
            raise ValueError("split keys must be non-empty")
        self.begins: List[Key] = [b""] + list(split_keys)
        self.n_shards = len(self.begins)

    def span_end(self, s: int) -> Optional[Key]:
        return self.begins[s + 1] if s + 1 < self.n_shards else None

    def shard_of_point_below(self, key: Key) -> int:
        """Shard owning the interval strictly below `key` (for empty reads:
        mirrors VersionIntervalMap.version_strictly_below's max(i,0))."""
        return max(bisect.bisect_left(self.begins, key) - 1, 0)

    def shards_of_range(self, begin: Key, end: Key) -> List[Tuple[int, Key, Key]]:
        """(shard, clipped_begin, clipped_end) for every span intersecting
        the non-empty range [begin, end)."""
        out = []
        lo = max(bisect.bisect_right(self.begins, begin) - 1, 0)
        for s in range(lo, self.n_shards):
            sb = self.begins[s]
            if sb >= end:
                break
            se = self.span_end(s)
            cb = max(begin, sb)
            ce = end if se is None else min(end, se)
            if cb < ce:
                out.append((s, cb, ce))
        return out
