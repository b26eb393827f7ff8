"""NativeConflictEngine: the C++ resolver engine behind the shared
ConflictSet contract.

Port of ``foundationdb_tpu/ops/native_engine.py``. The third pluggable
engine next to OracleConflictEngine (logical model) and
TorchConflictEngine (the card): an ordered-boundary-map resolver in C++
(``csrc/conflict_engine.cpp``, the reference's source unchanged), fed the
same columnar conflict-wire bytes the client serialized. It is the
framework's CPU-native analog of the reference's SkipList resolver — and
the CPU baseline a card engine's throughput is judged against (`-r
skiplisttest`, SkipList.cpp:1412).

The library is built with ``c++`` into ``_build/`` at first use
(``native/build.py``); a machine without a C++ compiler raises, and
nothing falls back to the oracle.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence

import numpy as np

from ..core.types import CommitTransaction, TransactionCommitResult, Version

_LIB = None
_LOCK = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded C++ engine, built first if needed (raises without a C++
    compiler), with every function's argument and result types declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ..native import build

            so = build.load("conflict_engine")
            i64 = ctypes.c_int64
            i64p = ctypes.POINTER(i64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            so.cse_new.restype = ctypes.c_void_p
            so.cse_new.argtypes = [i64]
            so.cse_free.restype = None
            so.cse_free.argtypes = [ctypes.c_void_p]
            so.cse_clear.restype = None
            so.cse_clear.argtypes = [ctypes.c_void_p, i64]
            so.cse_boundary_count.restype = i64
            so.cse_boundary_count.argtypes = [ctypes.c_void_p]
            so.cse_resolve.restype = ctypes.c_int
            so.cse_resolve.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int,
                i64p, i64, i64, u8p,
            ]
            _LIB = so
        return _LIB


class NativeConflictEngine:
    name = "native-cpp"

    def __init__(self, initial_version: Version = 0):
        self._lib = lib()
        self._h = self._lib.cse_new(initial_version)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.cse_free(h)
            self._h = None

    def clear(self, version: Version) -> None:
        self._lib.cse_clear(self._h, version)

    @property
    def boundary_count(self) -> int:
        return int(self._lib.cse_boundary_count(self._h))

    def resolve(
        self,
        transactions: Sequence[CommitTransaction],
        now: Version,
        new_oldest: Version,
    ) -> List[TransactionCommitResult]:
        n = len(transactions)
        if n == 0:
            return []
        # conflict_wire_block is cached on the transaction (core/types.py),
        # so a txn the client already serialized encodes zero times here
        blocks = [tr.conflict_wire_block() for tr in transactions]
        snaps = [tr.read_snapshot for tr in transactions]
        return self.resolve_wire(blocks, snaps, now, new_oldest)

    def resolve_wire(self, blocks: Sequence[bytes], snaps: Sequence[int],
                     now: Version, new_oldest: Version) -> List[TransactionCommitResult]:
        """Resolve pre-encoded conflict-wire blocks (the resolver-side
        entry: bytes in, verdicts out, no Python per-range objects)."""
        n = len(blocks)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in blocks], out=offs[1:])
        blob = b"".join(blocks)
        snaps_arr = np.asarray(snaps, np.int64)
        out = np.zeros(n, np.uint8)
        rc = self._lib.cse_resolve(
            self._h, blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            snaps_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            now, new_oldest,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise ValueError("malformed conflict-wire batch")
        return [TransactionCommitResult(int(s)) for s in out]
