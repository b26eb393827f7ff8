"""Columnar conflict-range wire blocks: the resolver's hot input format.

Port of the conflict-wire part of ``foundationdb_tpu/core/wire.py`` (the
record codec above it is not needed by the port). Each transaction's
conflict ranges travel as one compact little-endian block, so the engine's
columnar path turns a whole batch into device arrays with two native passes
(``csrc/fastpack.c``) instead of per-range Python objects:

  [u32 n_read][u32 n_write]
  then n_read read ranges followed by n_write write ranges, each:
    [u32 hdr]  hdr = begin_len | kind << 30
    [begin_len bytes]                         kind 0: POINT [k, k+'\\x00')
    [u32 end_len][end_len bytes]  (kind 1 only)     1: real range [b, e)
                                                    2: empty read [k, k)
"""
from __future__ import annotations

import struct

from .types import is_point_range

_KIND_POINT = 0
_KIND_RANGE = 1
_KIND_EMPTY = 2
_LEN_MASK = (1 << 30) - 1


def conflict_wire_ex(read_ranges, write_ranges):
    """Encode a transaction's conflict ranges (objects with ``begin`` and
    ``end`` bytes) as one wire block. Returns (block, all_point,
    max_key_len): the classification falls out of the encode and lets the
    engine skip whole-batch encodes the columnar path would reject."""
    parts = [struct.pack("<II", len(read_ranges), len(write_ranges))]
    all_point = True
    max_len = 0
    for rng in (*read_ranges, *write_ranges):
        b, e = rng.begin, rng.end
        if len(b) > max_len:
            max_len = len(b)
        if is_point_range(b, e):
            parts.append(struct.pack("<I", len(b) | (_KIND_POINT << 30)))
            parts.append(b)
        elif e <= b:
            parts.append(struct.pack("<I", len(b) | (_KIND_EMPTY << 30)))
            parts.append(b)
            all_point = False
        else:
            parts.append(struct.pack("<I", len(b) | (_KIND_RANGE << 30)))
            parts.append(b)
            parts.append(struct.pack("<I", len(e)))
            parts.append(e)
            all_point = False
            if len(e) > max_len:
                max_len = len(e)
    return b"".join(parts), all_point, max_len


def conflict_wire(read_ranges, write_ranges) -> bytes:
    return conflict_wire_ex(read_ranges, write_ranges)[0]


def conflict_unwire(block: bytes):
    """Decode a conflict wire block -> (read_ranges, write_ranges) as
    (begin, end) byte pairs: the inverse of conflict_wire."""
    nr, nw = struct.unpack_from("<II", block, 0)
    off = 8
    out = []
    for _ in range(nr + nw):
        (hdr,) = struct.unpack_from("<I", block, off)
        off += 4
        blen, kind = hdr & _LEN_MASK, hdr >> 30
        b = block[off:off + blen]
        off += blen
        if kind == _KIND_POINT:
            out.append((b, b + b"\x00"))
        elif kind == _KIND_EMPTY:
            out.append((b, b))
        else:
            (elen,) = struct.unpack_from("<I", block, off)
            off += 4
            out.append((b, block[off:off + elen]))
            off += elen
    return out[:nr], out[nr:]
