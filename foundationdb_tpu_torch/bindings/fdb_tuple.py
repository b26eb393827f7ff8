"""The tuple layer: order-preserving encoding of typed tuples into keys.

Port of ``foundationdb_tpu/bindings/fdb_tuple.py``.

Implements the reference's public tuple encoding specification
(design/tuple.md; bindings/python/fdb/tuple.py is the C-binding-backed
analog): each element is a type code byte followed by a self-delimiting
payload, chosen so that unsigned byte comparison of packed tuples equals
elementwise typed comparison of the tuples — the property every layer
built on range reads depends on.

Supported element types (the common subset every binding provides):
None, bytes, str (UTF-8), int (arbitrary precision), float (as IEEE
double), bool, uuid.UUID, and nested tuples/lists.
"""
from __future__ import annotations

import struct
import uuid
from typing import Any, List, Sequence, Tuple

NULL_CODE = 0x00
BYTES_CODE = 0x01
STRING_CODE = 0x02
NESTED_CODE = 0x05
NEG_INT_START = 0x0B      # arbitrary-precision negative: length byte is complemented
INT_ZERO_CODE = 0x14      # ints: 0x14 - 8 .. 0x14 + 8 by byte length
POS_INT_END = 0x1D        # arbitrary-precision positive: explicit length byte
DOUBLE_CODE = 0x21
FALSE_CODE = 0x26
TRUE_CODE = 0x27
UUID_CODE = 0x30

_ESCAPE = b"\x00\xff"


def _encode_bytes_body(b: bytes) -> bytes:
    """NUL-terminated with embedded NULs escaped as 00 FF — preserves order
    because FF cannot follow a real terminator."""
    return b.replace(b"\x00", _ESCAPE) + b"\x00"


def _decode_bytes_body(data: bytes, pos: int) -> Tuple[bytes, int]:
    out = bytearray()
    while True:
        i = data.index(b"\x00", pos)
        if i + 1 < len(data) and data[i + 1] == 0xFF:
            out += data[pos:i] + b"\x00"
            pos = i + 2
        else:
            out += data[pos:i]
            return bytes(out), i + 1


def _encode_int(v: int) -> bytes:
    if v == 0:
        return bytes([INT_ZERO_CODE])
    if v > 0:
        n = (v.bit_length() + 7) // 8
        if n > 8:
            # arbitrary precision: explicit length byte keeps longer ints sorting later
            if n > 255:
                raise ValueError("tuple layer big ints are limited to 255 bytes")
            return bytes([POS_INT_END, n]) + v.to_bytes(n, "big")
        return bytes([INT_ZERO_CODE + n]) + v.to_bytes(n, "big")
    n = ((-v).bit_length() + 7) // 8
    if n > 8:
        # negative big int: complemented length byte so longer (more negative) sorts first
        if n > 255:
            raise ValueError("tuple layer big ints are limited to 255 bytes")
        return bytes([NEG_INT_START, n ^ 0xFF]) + ((1 << (8 * n)) - 1 + v).to_bytes(n, "big")
    # negative: offset by the max so bigger magnitudes sort first
    return bytes([INT_ZERO_CODE - n]) + ((1 << (8 * n)) - 1 + v).to_bytes(n, "big")


def _encode_double(v: float) -> bytes:
    raw = bytearray(struct.pack(">d", v))
    # IEEE total-order transform: flip all bits of negatives, sign of positives
    if raw[0] & 0x80:
        raw = bytearray(b ^ 0xFF for b in raw)
    else:
        raw[0] ^= 0x80
    return bytes([DOUBLE_CODE]) + bytes(raw)


def _decode_double(data: bytes, pos: int) -> Tuple[float, int]:
    raw = bytearray(data[pos:pos + 8])
    if raw[0] & 0x80:
        raw[0] ^= 0x80
    else:
        raw = bytearray(b ^ 0xFF for b in raw)
    return struct.unpack(">d", bytes(raw))[0], pos + 8


def _encode_one(v: Any, nested: bool) -> bytes:
    if v is None:
        # inside nested tuples, None is 00 FF so it can't terminate the nest
        return b"\x00\xff" if nested else bytes([NULL_CODE])
    if isinstance(v, bool):   # before int: bool is an int subclass
        return bytes([TRUE_CODE if v else FALSE_CODE])
    if isinstance(v, bytes):
        return bytes([BYTES_CODE]) + _encode_bytes_body(v)
    if isinstance(v, str):
        return bytes([STRING_CODE]) + _encode_bytes_body(v.encode("utf-8"))
    if isinstance(v, int):
        return _encode_int(v)
    if isinstance(v, float):
        return _encode_double(v)
    if isinstance(v, uuid.UUID):
        return bytes([UUID_CODE]) + v.bytes
    if isinstance(v, (tuple, list)):
        body = b"".join(_encode_one(x, nested=True) for x in v)
        return bytes([NESTED_CODE]) + body + b"\x00"
    raise TypeError(f"tuple layer cannot encode {type(v).__name__}")


def pack(t: Sequence[Any], prefix: bytes = b"") -> bytes:
    """Encode a tuple to a key; byte order == typed tuple order."""
    return prefix + b"".join(_encode_one(v, nested=False) for v in t)


def _decode_one(data: bytes, pos: int, nested: bool) -> Tuple[Any, int]:
    code = data[pos]
    pos += 1
    if code == NULL_CODE:
        if nested and pos < len(data) and data[pos] == 0xFF:
            return None, pos + 1
        return None, pos
    if code == BYTES_CODE:
        return _decode_bytes_body(data, pos)
    if code == STRING_CODE:
        raw, pos = _decode_bytes_body(data, pos)
        return raw.decode("utf-8"), pos
    if code == NESTED_CODE:
        out: List[Any] = []
        while True:
            if data[pos] == 0x00 and not (pos + 1 < len(data) and data[pos + 1] == 0xFF):
                return tuple(out), pos + 1
            v, pos = _decode_one(data, pos, nested=True)
            out.append(v)
    if code == DOUBLE_CODE:
        return _decode_double(data, pos)
    if code == FALSE_CODE:
        return False, pos
    if code == TRUE_CODE:
        return True, pos
    if code == UUID_CODE:
        return uuid.UUID(bytes=data[pos:pos + 16]), pos + 16
    if code == POS_INT_END:
        n = data[pos]
        return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), pos + 1 + n
    if code == NEG_INT_START:
        n = data[pos] ^ 0xFF
        return (int.from_bytes(data[pos + 1:pos + 1 + n], "big")
                - ((1 << (8 * n)) - 1)), pos + 1 + n
    if INT_ZERO_CODE - 8 <= code <= INT_ZERO_CODE + 8:
        n = code - INT_ZERO_CODE
        if n == 0:
            return 0, pos
        if n > 0:
            return int.from_bytes(data[pos:pos + n], "big"), pos + n
        n = -n
        return int.from_bytes(data[pos:pos + n], "big") - ((1 << (8 * n)) - 1), pos + n
    raise ValueError(f"unknown tuple type code 0x{code:02x} at {pos - 1}")


def unpack(key: bytes, prefix: bytes = b"") -> Tuple[Any, ...]:
    assert key.startswith(prefix), "key does not carry the expected prefix"
    out: List[Any] = []
    pos = len(prefix)
    while pos < len(key):
        v, pos = _decode_one(key, pos, nested=False)
        out.append(v)
    return tuple(out)


def range_of(t: Sequence[Any], prefix: bytes = b"") -> Tuple[bytes, bytes]:
    """[begin, end) covering every tuple that extends `t` (fdb.tuple.range)."""
    p = pack(t, prefix)
    return p + b"\x00", p + b"\xff"
