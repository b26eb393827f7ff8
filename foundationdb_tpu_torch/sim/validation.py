"""Magic durability assertions, usable only in simulation.

Port of ``foundationdb_tpu/sim/validation.py``.

Re-design of fdbrpc/sim_validation.h:20-50 (debug_advanceMaxCommittedVersion
/ debug_checkRestoredVersion): the simulator tracks, OUT OF BAND, the
highest commit version whose tlog push fully acked. Every epoch-end
recovery must pick a recovery version at or above it — a lower one would
silently discard data the cluster already acknowledged as durable. The
check is global and unconditional in sim: it rides every spec (attrition
included) for free, catching recovery-version math bugs that workload
invariants can miss (a dropped suffix of acked-but-unread writes).

Violations are RECORDED, not raised: a raise inside the master's recovery
actor would surface as just another master failure and be retried into
silence. The spec runner asserts the violation list is empty at the end of
every run (SevError semantics: any violation fails the test).
"""
from __future__ import annotations

from typing import List, Tuple

_enabled = False
#: per-GENERATION acked-push watermark: gen_id -> max fully-acked version.
#: Scoped by generation (recovery_count, master_salt — globally unique in
#: a sim), because (a) the min(end) invariant binds a recovery to the
#: generation it LOCKED, and (b) one simulation can host several clusters
#: (backup/DR specs) whose version chains are unrelated
_max_committed: dict = {}
#: gen_id -> the recovery version its epoch END chose: any LATER
#: fully-acked push above it is a zombie ack (a deposed generation's
#: straggler completing after recovery discarded those versions)
_recovered: dict = {}
#: (gen_id, recovery_version, max_committed_at_check) per violation
violations: List[Tuple] = []


def enable() -> None:
    """Arm the oracle (the simulator's constructor calls this)."""
    global _enabled
    _enabled = True
    _max_committed.clear()
    _recovered.clear()
    violations.clear()


def disable() -> None:
    global _enabled
    _enabled = False
    _max_committed.clear()
    _recovered.clear()


def advance_max_committed(gen_id, version: int) -> None:
    """A commit's log-system push to generation `gen_id` fully acked at
    `version` (the durability point recovery must honor). An ack landing
    ABOVE a recovery that already ended this generation's epoch is itself
    a violation (zombie push: the commit is acked, the versions are
    discarded — the durable-tlog-lock bug's exact shape). No-op outside
    simulation."""
    if not _enabled:
        return
    if version > _max_committed.get(gen_id, 0):
        _max_committed[gen_id] = version
    rec = _recovered.get(gen_id)
    if rec is not None and version > rec:
        violations.append((gen_id, rec, version))


def check_restored_version(gen_id, recovery_version: int) -> None:
    """An epoch-end recovery of generation `gen_id` chose
    `recovery_version`: it must cover every fully-acked push to that
    generation (all-ack means any locked replica bounds it from above, so
    min(end) over the locked set can never be below a completed push — if
    it is, the lock/recovery math lost acknowledged data)."""
    if not _enabled:
        return
    if recovery_version < _max_committed.get(gen_id, 0):
        violations.append((gen_id, recovery_version, _max_committed[gen_id]))
    prev = _recovered.get(gen_id)
    if prev is None or recovery_version < prev:
        # min over competing recoveries of the same generation (a lower
        # later choice is the binding one)
        _recovered[gen_id] = recovery_version


def max_committed(gen_id) -> int:
    return _max_committed.get(gen_id, 0)
