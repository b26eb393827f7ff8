"""Numbered error codes.

Port of ``foundationdb_tpu/core/error.py``: the same codes, names and
retry classes, so callers key off the same numbers whichever package runs.

Analog of the reference's error system (flow/error_definitions.h, flow/Error.h):
every recoverable failure is a numbered error, and the client's on_error retry
loop keys off specific codes. Numbers match the reference where the concept
maps 1:1 so users of the reference find familiar codes.
"""
from __future__ import annotations


class FDBError(Exception):
    def __init__(self, code: int, name: str, message: str = ""):
        super().__init__(f"{name} ({code})" + (f": {message}" if message else ""))
        self.code = code
        self.name = name

    def is_retryable(self) -> bool:
        return self.code in _RETRYABLE

    def is_maybe_committed(self) -> bool:
        return self.code in _MAYBE_COMMITTED


_REGISTRY: dict[int, tuple[str, str]] = {}
_RETRYABLE: set[int] = set()
_MAYBE_COMMITTED: set[int] = set()


def _define(code: int, name: str, desc: str, retryable: bool = False, maybe_committed: bool = False):
    _REGISTRY[code] = (name, desc)
    if retryable:
        _RETRYABLE.add(code)
    if maybe_committed:
        _MAYBE_COMMITTED.add(code)

    def make(message: str = "") -> FDBError:
        return FDBError(code, name, message)

    return make


class OperationCancelled(BaseException):
    """Actor cancellation (flow: actor_cancelled). Deliberately NOT an
    FDBError/Exception subclass: the reference's actor compiler propagates
    cancellation through user catch blocks automatically, and retry loops
    written as `except FDBError` must never swallow a cancellation and keep
    looping. Carries the same shape as FDBError for uniform reporting."""

    def __init__(self, message: str = ""):
        super().__init__("operation_cancelled (1101)" + (f": {message}" if message else ""))
        self.code = 1101
        self.name = "operation_cancelled"

    def is_retryable(self) -> bool:
        return False

    def is_maybe_committed(self) -> bool:
        return False


def operation_cancelled(message: str = "") -> OperationCancelled:
    return OperationCancelled(message)


# Codes mirror flow/error_definitions.h where applicable.
operation_failed = _define(1000, "operation_failed", "Operation failed")
timed_out = _define(1004, "timed_out", "Operation timed out")
watch_cancelled = _define(1101, "watch_cancelled", "Watch expired by the server", retryable=True)
transaction_too_old = _define(1007, "transaction_too_old", "Read version is too old", retryable=True)
future_version = _define(1009, "future_version", "Version is ahead of storage", retryable=True)
wrong_shard_server = _define(1001, "wrong_shard_server", "Shard is on another server", retryable=True)
not_committed = _define(1020, "not_committed", "Transaction conflicted, not committed", retryable=True)
commit_unknown_result = _define(
    1021, "commit_unknown_result", "Commit result unknown", retryable=True, maybe_committed=True
)
transaction_cancelled = _define(1025, "transaction_cancelled", "Transaction cancelled")
connection_failed = _define(1026, "connection_failed", "Connection failed", retryable=True)
coordinators_changed = _define(1027, "coordinators_changed", "Coordinators changed", retryable=True)
request_maybe_delivered = _define(1030, "request_maybe_delivered", "Request may or may not have been delivered")
broken_promise = _define(1100, "broken_promise", "The promise was dropped before being set")
master_recovery_failed = _define(1203, "master_recovery_failed", "Master recovery failed")
tlog_stopped = _define(1011, "tlog_stopped", "TLog stopped")
worker_removed = _define(1202, "worker_removed", "Worker removed by cluster controller")
recruitment_failed = _define(1200, "recruitment_failed", "Role recruitment failed")
master_tlog_failed = _define(1205, "master_tlog_failed", "Master terminating because a TLog failed")
movekeys_conflict = _define(1010, "movekeys_conflict", "Concurrent data-distribution move")
database_locked = _define(1038, "database_locked", "Database is locked (DR switchover / management)")
transaction_throttled = _define(
    1213, "transaction_throttled",
    "Tenant over its admission rate; retry after backoff", retryable=True)
transaction_conflict_predicted = _define(
    1214, "transaction_conflict_predicted",
    "Conflict scheduler predicts this transaction is doomed; refresh read "
    "version and retry", retryable=True)
please_reboot = _define(1207, "please_reboot", "Process should reboot")
io_error = _define(1510, "io_error", "Disk i/o operation failed")
file_not_found = _define(1511, "file_not_found", "File not found")
key_outside_legal_range = _define(2004, "key_outside_legal_range", "Key outside legal range")
inverted_range = _define(2005, "inverted_range", "Range begin key exceeds end key")
used_during_commit = _define(2017, "used_during_commit", "Operation issued while a commit was outstanding")
accessed_unreadable = _define(1036, "accessed_unreadable", "Read or wrote an unreadable key (versionstamped this transaction)")
client_invalid_operation = _define(2000, "client_invalid_operation", "Invalid API operation")
conflict_capacity_exceeded = _define(
    2101, "conflict_capacity_exceeded", "Device conflict table capacity exceeded"
)
device_fault = _define(
    2103, "device_fault", "Conflict engine device dispatch failed", retryable=True
)
key_too_large = _define(2102, "key_too_large", "Key exceeds the engine's exact-compare width")
end_of_stream = _define(1, "end_of_stream", "End of stream")
internal_error = _define(4100, "internal_error", "An internal error occurred")
