"""Static and epoched key-range shard maps.

Port of ``foundationdb_tpu/core/keyshard.py``. The analog of the proxy's
`keyResolvers` range map (MasterProxyServer.actor.cpp:263-316). The engine
routes every row through a one-shard map; the elastic resolver group
(server/reshard.py) routes batches through an epoched chain of them.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from . import wire
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

    @staticmethod
    def uniform(n_shards: int) -> "KeyShardMap":
        """Evenly split on the first key byte."""
        if n_shards == 1:
            return KeyShardMap([])
        if n_shards > 256:
            raise ValueError("one-byte granularity cannot split past 256 shards")
        return KeyShardMap([bytes([(256 * i) // n_shards]) for i in range(1, n_shards)])

    @staticmethod
    def from_split_points(splits: Sequence[Key], n_shards: int) -> "KeyShardMap":
        """An n_shards-way map from measured split keys (the heat
        aggregator's split_points()), sanitized: sorted, deduplicated,
        non-empty keys only; anything short of the n_shards - 1 boundaries
        a full map needs falls back to the byte-uniform split."""
        clean = sorted({bytes(k) for k in splits if k})
        if len(clean) != max(int(n_shards), 1) - 1:
            return KeyShardMap.uniform(n_shards)
        return KeyShardMap(clean)

    def span_end(self, s: int) -> Optional[Key]:
        return self.begins[s + 1] if s + 1 < self.n_shards else None

    def shard_of_key(self, key: Key) -> int:
        """Shard owning `key` (span containing it)."""
        return max(bisect.bisect_right(self.begins, key) - 1, 0)

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


class EpochedKeyShardMap:
    """Versioned shard map: a monotone sequence of (epoch, flip_version,
    KeyShardMap) entries, atomically flipped at a chosen commit version.

    Every consumer routes a batch by the newest epoch whose flip_version
    is <= the batch's commit version, so a transaction resolves under
    exactly ONE epoch (the one its batch version selects), never both
    sides of a flip. Epochs fully below the GC horizon are pruned (`gc`);
    the newest epoch at or below the horizon is always kept (it still
    routes the horizon itself). Wire-serializable like KeyShardMap."""

    def __init__(self, initial: KeyShardMap, flip_version: int = 0, epoch: int = 0):
        #: ascending (epoch, flip_version, map)
        self.epochs: List[Tuple[int, int, KeyShardMap]] = [(int(epoch), int(flip_version), initial)]

    @property
    def epoch(self) -> int:
        return self.epochs[-1][0]

    @property
    def flip_version(self) -> int:
        return self.epochs[-1][1]

    def current(self) -> KeyShardMap:
        return self.epochs[-1][2]

    def map_for_version(self, version: int) -> KeyShardMap:
        """The map that resolves `version`: newest epoch at or below it
        (versions below the first retained flip route by that first
        epoch: its predecessors were GC'd because nothing below the
        horizon may resolve any more)."""
        return self.entry_for_version(version)[2]

    def entry_for_version(self, version: int) -> Tuple[int, int, KeyShardMap]:
        for e in reversed(self.epochs):
            if version >= e[1]:
                return e
        return self.epochs[0]

    def flip(self, new_map: KeyShardMap, flip_version: int) -> int:
        """Install `new_map` for every version >= flip_version; returns
        the new epoch id. Flips are strictly ordered: a flip at or below
        the newest one would make routing ambiguous for the overlap."""
        if flip_version <= self.flip_version:
            raise ValueError(f"flip at v{flip_version} not above newest v{self.flip_version}")
        e = self.epoch + 1
        self.epochs.append((e, int(flip_version), new_map))
        return e

    def gc(self, oldest_version: int) -> None:
        """Drop epochs no version >= oldest_version can route by."""
        while len(self.epochs) > 1 and self.epochs[1][1] <= oldest_version:
            self.epochs.pop(0)

    def as_dict(self) -> dict:
        # keys render through _fmt_key: this dict rides report JSON
        return {
            "epoch": self.epoch,
            "flip_version": self.flip_version,
            "n_shards": self.current().n_shards,
            "splits": [_fmt_key(k) for k in self.current().begins[1:]],
            "history": [{"epoch": e, "flip_version": fv,
                         "splits": [_fmt_key(k) for k in m.begins[1:]]}
                        for e, fv, m in self.epochs],
        }


def _epoched_from_state(rows) -> EpochedKeyShardMap:
    e0, fv0, splits0 = rows[0]
    em = EpochedKeyShardMap(KeyShardMap(list(splits0)), fv0, e0)
    em.epochs = [(int(e), int(fv), KeyShardMap(list(s))) for e, fv, s in rows]
    return em


# wire codecs, the reference's names and states: a shard map is fully
# described by its split keys, the epoch chain by its (epoch, flip_version,
# splits) rows
wire.register_adapter(KeyShardMap, "KeyShardMap", to_state=lambda m: list(m.begins[1:]),
                      from_state=lambda splits: KeyShardMap(splits))
wire.register_adapter(EpochedKeyShardMap, "EpochedKeyShardMap",
                      to_state=lambda em: [(e, fv, list(m.begins[1:])) for e, fv, m in em.epochs],
                      from_state=_epoched_from_state)
