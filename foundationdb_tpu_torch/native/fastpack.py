"""ctypes binding of the host packer ``csrc/fastpack.c``.

``lib()`` builds the source at first use (``build.load``: cc into
``_build/``, keyed by the source hash) and declares every function's
argument and result types. A failed build raises; there is no Python
fallback.
"""
from __future__ import annotations

import ctypes
import threading

_LIB = None
_LOCK = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded packer, built first if needed. Thread-safe: the pipeline
    may pack on an executor thread."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from . import build

            so = build.load("fastpack")
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            so.conflict_counts.restype = ctypes.c_int
            so.conflict_counts.argtypes = [
                ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64, i32p, i32p]
            so.build_point_rows.restype = None
            so.build_point_rows.argtypes = [
                ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64, u32p, i32p, u32p, i32p, i64p]
            so.conflict_counts_sharded.restype = ctypes.c_int
            so.conflict_counts_sharded.argtypes = [
                ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_char_p, i64p, ctypes.c_int64, i32p, i32p]
            so.build_point_rows_sharded.restype = None
            so.build_point_rows_sharded.argtypes = [
                ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, i64p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, u32p, i32p, u32p, i32p, i64p]
            _LIB = so
        return _LIB
