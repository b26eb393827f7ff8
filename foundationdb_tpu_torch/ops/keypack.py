"""Fixed-width order-preserving key packing for the conflict kernel.

A key (bytes) is packed into ``key_words`` big-endian uint32 words (zero
padded) plus a final length word. Lexicographic comparison of the resulting
(words..., length) tuple is exactly the reference's key order — bytewise,
shorter-is-less on equal prefix (fdbserver/SkipList.cpp:113-120) — for all
keys of length <= 4*key_words.

Longer keys never reach pack_keys: the engine sends long POINT rows to its
exact host tier (host_engine.py), and long RANGE ENDPOINTS are packed by
pack_endpoint_keys, which truncates to the window with length window+1. The
truncated form compares identically to the original against every in-window
key, so device-side interval membership of short keys stays exact and
long-key membership is owned by the host tier.

The packed arrays are numpy uint32; conflict_kernel.batch_from_numpy widens
them to int64 tensors on the way to the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import error


def max_key_bytes(key_words: int) -> int:
    return 4 * key_words


def pack_keys(keys: Sequence[bytes], key_words: int) -> np.ndarray:
    """Pack N keys -> uint32 [N, key_words + 1] (words..., length), by one
    join and a big-endian uint32 view."""
    n = len(keys)
    kb = max_key_bytes(key_words)
    if n == 0:
        return np.zeros((0, key_words + 1), np.uint32)
    lens = np.fromiter((len(k) for k in keys), np.int64, count=n)
    if int(lens.max()) > kb:
        raise error.key_too_large(
            f"key of {int(lens.max())} bytes > engine width {kb}")
    flat = np.frombuffer(
        b"".join(k.ljust(kb, b"\0") for k in keys), dtype=np.uint8
    ).reshape(n, kb)
    packed = flat.view(">u4").astype(np.uint32)
    return np.concatenate([packed, lens[:, None].astype(np.uint32)], axis=1)


def pack_endpoint_keys(keys: Sequence[bytes], key_words: int) -> np.ndarray:
    """pack_keys for RANGE ENDPOINTS: keys longer than the window are
    truncated to (first window bytes, length=window+1) — see the module
    docstring for why this is exact for in-window membership."""
    kb = max_key_bytes(key_words)
    if all(len(k) <= kb for k in keys):
        return pack_keys(keys, key_words)
    out = pack_keys([k[:kb] for k in keys], key_words)
    for i, k in enumerate(keys):
        if len(k) > kb:
            out[i, key_words] = kb + 1
    return out


def pack_key(key: bytes, key_words: int) -> np.ndarray:
    return pack_keys([key], key_words)[0]


def unpack_key(packed: np.ndarray, key_words: int) -> bytes:
    """Inverse of pack_key (for debugging and tests)."""
    length = int(packed[key_words])
    raw = np.asarray(packed[:key_words], np.uint32).astype(">u4").tobytes()
    return raw[:length]
