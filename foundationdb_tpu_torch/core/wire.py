"""On-disk serialization and the resolver's columnar conflict wire.

Port of ``foundationdb_tpu/core/wire.py``. Two formats:

*Named records* (`dumps` / `loads`): a tagged, versioned flat binary
format (the analog of flow/serialize.h's byte-stable versioned
serializers) for everything that touches a disk, the black-box journal
first. Unlike pickle, the bytes do not depend on Python class layout:

  * scalars/containers use fixed type tags + varints;
  * dataclasses are encoded as NAMED records listing (field name, value)
    pairs against a registry (register_record) — a vN payload read by a
    vN+1 binary simply ignores fields it dropped and defaults fields it
    added, which is what makes restart-across-upgrade safe;
  * enums encode as (registered name, integer value).

A record's name is its class ``__name__``, so the same record dumps to
the same bytes in both packages. The header carries a magic byte + format
version so a future incompatible format can bump it and keep a reader for
the old one.

*Conflict wire blocks*: each transaction's conflict ranges travel as one
compact little-endian block, so the engine's columnar path turns a whole
batch into device arrays with two native passes (``csrc/fastpack.c``)
instead of per-range Python objects:

  [u32 n_read][u32 n_write]
  then n_read read ranges followed by n_write write ranges, each:
    [u32 hdr]  hdr = begin_len | kind << 30
    [begin_len bytes]                         kind 0: POINT [k, k+'\\x00')
    [u32 end_len][end_len bytes]  (kind 1 only)     1: real range [b, e)
                                                    2: empty read [k, k)
"""
from __future__ import annotations

import struct
from enum import Enum
from typing import Any, Callable, Dict, Tuple, Type

MAGIC = 0xF7
FORMAT_VERSION = 1

_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3
_T_BYTES = 4
_T_STR = 5
_T_LIST = 6
_T_TUPLE = 7
_T_DICT = 8
_T_SET = 9
_T_RECORD = 10
_T_ENUM = 11
_T_FLOAT = 12
_T_FROZENSET = 13

_RECORDS: Dict[str, Type] = {}
_RECORD_NAMES: Dict[Type, str] = {}
_ENUMS: Dict[str, Type] = {}
_ENUM_NAMES: Dict[Type, str] = {}
#: non-dataclass types with explicit (to_state, from_state) codecs, encoded
#: as single-field records — e.g. KeyShardMap, which is fully described by
#: its split keys but derives its fields in __init__
_ADAPTERS: Dict[Type, Tuple[str, Callable]] = {}
_ADAPTER_DECODERS: Dict[str, Callable] = {}


def register_adapter(cls: Type, name: str, to_state: Callable, from_state: Callable) -> Type:
    """Register a custom codec: `to_state(obj)` must return a wire-encodable
    value; `from_state(state)` reconstructs the object."""
    _ADAPTERS[cls] = (name, to_state)
    _ADAPTER_DECODERS[name] = from_state
    return cls

#: modules whose import registers every record reachable from disk state,
#: named relative to this package; imported lazily on the first unknown
#: record (a restore may run before the defining module was imported)
_LAZY_REGISTRARS = (
    "..core.types",
    # TraceContext — the propagated distributed-tracing context
    "..core.trace",
)


def _import_registrars() -> None:
    import importlib

    for mod in _LAZY_REGISTRARS:
        importlib.import_module(mod, __package__)


def register_record(cls: Type, name: str = "") -> Type:
    """Register a dataclass for named-record encoding (call at module
    import from the defining module). Field names are the schema."""
    n = name or cls.__name__
    _RECORDS[n] = cls
    _RECORD_NAMES[cls] = n
    return cls


def register_enum(cls: Type, name: str = "") -> Type:
    n = name or cls.__name__
    _ENUMS[n] = cls
    _ENUM_NAMES[cls] = n
    return cls


def _write_varint(out: bytearray, v: int) -> None:
    # zigzag + LEB128; arbitrary precision (a fixed-width shift would
    # corrupt ints below -2^63)
    u = ((-v) << 1) - 1 if v < 0 else v << 1
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(raw: bytes, off: int) -> Tuple[int, int]:
    u = 0
    shift = 0
    while True:
        b = raw[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1), off


def _encode(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, Enum):
        cls = type(obj)
        name = _ENUM_NAMES.get(cls)
        if name is None:
            raise TypeError(f"unregistered enum {cls.__name__}")
        out.append(_T_ENUM)
        _encode_str(out, name)
        _write_varint(out, int(obj.value))
    elif isinstance(obj, int):
        out.append(_T_INT)
        _write_varint(out, obj)
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out += struct.pack("<d", obj)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_T_BYTES)
        _write_varint(out, len(obj))
        out += obj
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        _write_varint(out, len(raw))
        out += raw
    elif isinstance(obj, list):
        out.append(_T_LIST)
        _write_varint(out, len(obj))
        for x in obj:
            _encode(out, x)
    elif isinstance(obj, tuple):
        out.append(_T_TUPLE)
        _write_varint(out, len(obj))
        for x in obj:
            _encode(out, x)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        _write_varint(out, len(obj))
        for k, v in obj.items():
            _encode(out, k)
            _encode(out, v)
    elif isinstance(obj, frozenset):
        out.append(_T_FROZENSET)
        _write_varint(out, len(obj))
        for x in sorted(obj, key=repr):
            _encode(out, x)
    elif isinstance(obj, set):
        out.append(_T_SET)
        _write_varint(out, len(obj))
        for x in sorted(obj, key=repr):
            _encode(out, x)
    else:
        adapter = _ADAPTERS.get(type(obj))
        if adapter is not None:
            name, to_state = adapter
            out.append(_T_RECORD)
            _encode_str(out, name)
            _write_varint(out, 1)
            _encode_str(out, "state")
            _encode(out, to_state(obj))
            return
        name = _RECORD_NAMES.get(type(obj))
        if name is None:
            raise TypeError(f"wire cannot encode {type(obj).__name__}: "
                            "register_record it or use plain containers")
        import dataclasses

        fields = dataclasses.fields(obj)
        out.append(_T_RECORD)
        _encode_str(out, name)
        _write_varint(out, len(fields))
        for f in fields:
            _encode_str(out, f.name)
            _encode(out, getattr(obj, f.name))


def _encode_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    _write_varint(out, len(raw))
    out += raw


def _decode_str(raw: bytes, off: int) -> Tuple[str, int]:
    n, off = _read_varint(raw, off)
    return raw[off:off + n].decode("utf-8"), off + n


def _resolve_record(name: str) -> Type:
    cls = _RECORDS.get(name)
    if cls is None:
        _import_registrars()
        cls = _RECORDS.get(name)
    if cls is None:
        raise ValueError(f"unknown wire record type {name!r}")
    return cls


def _decode(raw: bytes, off: int) -> Tuple[Any, int]:
    tag = raw[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_INT:
        return _read_varint(raw, off)
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", raw, off)[0], off + 8
    if tag == _T_BYTES:
        n, off = _read_varint(raw, off)
        return bytes(raw[off:off + n]), off + n
    if tag == _T_STR:
        n, off = _read_varint(raw, off)
        return raw[off:off + n].decode("utf-8"), off + n
    if tag in (_T_LIST, _T_TUPLE, _T_SET, _T_FROZENSET):
        n, off = _read_varint(raw, off)
        items = []
        for _ in range(n):
            x, off = _decode(raw, off)
            items.append(x)
        if tag == _T_LIST:
            return items, off
        if tag == _T_TUPLE:
            return tuple(items), off
        if tag == _T_SET:
            return set(items), off
        return frozenset(items), off
    if tag == _T_DICT:
        n, off = _read_varint(raw, off)
        d = {}
        for _ in range(n):
            k, off = _decode(raw, off)
            v, off = _decode(raw, off)
            d[k] = v
        return d, off
    if tag == _T_ENUM:
        name, off = _decode_str(raw, off)
        v, off = _read_varint(raw, off)
        cls = _ENUMS.get(name)
        if cls is None:
            _import_registrars()
            cls = _ENUMS.get(name)
        if cls is None:
            raise ValueError(f"unknown wire enum {name!r}")
        return cls(v), off
    if tag == _T_RECORD:
        name, off = _decode_str(raw, off)
        nf, off = _read_varint(raw, off)
        got: Dict[str, Any] = {}
        for _ in range(nf):
            fname, off = _decode_str(raw, off)
            val, off = _decode(raw, off)
            got[fname] = val
        dec = _ADAPTER_DECODERS.get(name)
        if dec is None and name not in _RECORDS:
            _import_registrars()
            dec = _ADAPTER_DECODERS.get(name)
        if dec is not None:
            return dec(got["state"]), off
        cls = _resolve_record(name)
        import dataclasses

        known = {f.name for f in dataclasses.fields(cls)}
        # tolerant schema evolution: drop fields the reader no longer has;
        # fields the reader added (with defaults) stay at their defaults
        return cls(**{k: v for k, v in got.items() if k in known}), off
    raise ValueError(f"bad wire tag {tag} at {off - 1}")


def dumps(obj) -> bytes:
    out = bytearray([MAGIC, FORMAT_VERSION])
    _encode(out, obj)
    return bytes(out)


def loads(raw: bytes):
    if len(raw) < 2 or raw[0] != MAGIC:
        raise ValueError("not a wire payload (bad magic)")
    if raw[1] != FORMAT_VERSION:
        raise ValueError(f"unsupported wire format version {raw[1]}")
    obj, _off = _decode(raw, 2)
    return obj



# -- columnar conflict-range wire blocks ----------------------------------------
from .types import is_point_range  # noqa: E402  (types registers its records above)

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
