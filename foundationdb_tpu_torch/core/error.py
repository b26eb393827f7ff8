"""Numbered errors the conflict check raises.

Codes match ``foundationdb_tpu/core/error.py`` (and, where the concept maps,
the reference's flow/error_definitions.h), so callers key off the same
numbers whichever engine they run.
"""
from __future__ import annotations


class FDBError(Exception):
    def __init__(self, code: int, name: str, message: str = ""):
        super().__init__(f"{name} ({code})" + (f": {message}" if message else ""))
        self.code = code
        self.name = name


def _define(code: int, name: str):
    def make(message: str = "") -> FDBError:
        return FDBError(code, name, message)

    return make


client_invalid_operation = _define(2000, "client_invalid_operation")
conflict_capacity_exceeded = _define(2101, "conflict_capacity_exceeded")
key_too_large = _define(2102, "key_too_large")
