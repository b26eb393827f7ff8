"""Crash-stop recovery: durable resolver restart from the black-box journal.

Port of ``foundationdb_tpu/fault/recovery.py``: the same snapshot record,
`FBSN` frame, file names and recovery modes, so a directory either
package wrote recovers in the other.

The reference's defining robustness property is that recovery is the
COMMON case — any process dies at any instant and the cluster
reconverges to bit-identical state. Everything below the process
boundary already survives here (device faults, network chaos, live
resharding), but a `kill -9` of a resolver lost everything above the
durable journal: the interval-table state existed only in the in-memory
shadow. This module closes that gap with the PAM shape (PAPERS.md):
periodic snapshots plus O(delta) journal replay.

  * **Snapshots** (`SnapshotManager`): the supervised engine's committed
    write-history window — the same shadow whose sufficiency argument
    makes failover rebuilds bit-identical (fault/resilient.py) — is
    COALESCED through the handoff pre-copy machinery (fault/handoff.py),
    so a snapshot is bounded by distinct keys, not history length. It is
    wire-serialized, crc-framed (`FBSN` magic) and written atomically
    BESIDE the journal segments (`snap-*.snap`; the journal's
    `bbox-*.seg` globbing never sees them) every
    `resolver_recovery_snapshot_interval` commit versions.

  * **Recovery** (`recover()`): newest readable snapshot (a torn tail
    falls back to the previous one) replays into the fresh supervised
    engine — too-old gate pinned first, then one write-only batch per
    distinct version at its ORIGINAL version, the `_replay_shadow`
    contract — then the journal's batch suffix above the snapshot
    version re-resolves through the engine at original versions. The
    replayed verdicts diff bit-for-bit against the journal's recorded
    ones: a clean run converges to verdict-bit-identical state vs. an
    uninterrupted engine (tests/test_recovery.py pins it across a
    reshard epoch flip).

  * **Honest coverage**: rotation may have eaten the horizon between the
    snapshot and the retained journal head. That is a TYPED degraded
    mode (`from_floor`), not silently-wrong history: the too-old gate is
    pinned at the first retained version, so reads below the missing
    window answer `transaction_too_old` instead of resolving against
    state that cannot be proven (`coverage_ok=False` in the result, the
    forensics diff_replay convention).

The arc lands in the journal itself (`snapshot` / `recovery` events,
core/blackbox.py) — `cli recovery` renders the last recovery from the
durable record — and in a `recovery.blackout` span the crash campaign
(real/nemesis.py --crash) verifies against `resolver_recovery_budget_ms`.
A `RecoveryTracker` registered with the telemetry hub feeds the
watchdog's `recovery_stalled` rule (core/watchdog.py).
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core import blackbox, progcache, telemetry, wire
from ..core.trace import span_event, span_now
from . import handoff

#: snapshot file header: magic + format version
SNAP_MAGIC = b"FBSN"
SNAP_VERSION = 1
_HEADER = SNAP_MAGIC + bytes([SNAP_VERSION])
#: one crc frame per snapshot: little-endian (payload length, crc32)
_FRAME = struct.Struct("<II")

#: typed recovery modes (RecoveryResult.mode)
MODE_COMPLETE = "complete"      #: snapshot + full suffix — provably exact
MODE_FROM_FLOOR = "from_floor"  #: rotation ate the horizon — gate pinned
MODE_COLD = "cold"              #: nothing durable retained — empty engine


@dataclass
class EngineSnapshot:
    """One coalesced engine-state snapshot (wire-serialized)."""

    version: int = 0      #: newest shadow version captured (recovery floor)
    oldest: int = 0       #: the MVCC too-old gate at capture
    t: float = 0.0
    proc: str = ""
    #: ((version, ((begin, end), ...)), ...) — one write-only batch per
    #: distinct surviving version, ascending (handoff.coalesce output)
    entries: Tuple = ()


wire.register_record(EngineSnapshot)


# -- snapshot files ------------------------------------------------------------

def snapshot_path(directory: str, version: int) -> str:
    return os.path.join(directory, f"snap-{version:014d}.snap")


def snapshot_paths(directory: str) -> List[Tuple[int, str]]:
    """(version, path) for every snapshot file, ascending by version."""
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("snap-") and n.endswith(".snap")]
    except OSError:
        return []
    out = []
    for n in sorted(names):
        try:
            out.append((int(n[len("snap-"):-len(".snap")]),
                        os.path.join(directory, n)))
        except ValueError:
            continue
    return out


def capture(engine, proc: str = "", now_fn=span_now) -> EngineSnapshot:
    """The supervised engine's full shadow window, coalesced to the
    effective interval map (bounded by distinct keys, not history)."""
    entries = handoff.coalesce(
        handoff.shadow_slice(engine, b"", None, 0), b"", None)
    return EngineSnapshot(
        version=int(handoff.last_shadow_version(engine)),
        oldest=int(getattr(engine, "_oldest", 0)),
        t=round(float(now_fn()), 6), proc=proc,
        entries=tuple((int(v), tuple(w)) for v, w in entries))


def write_snapshot(directory: str, snap: EngineSnapshot,
                   disk: Optional[Any] = None) -> Optional[dict]:
    """Serialize `snap` atomically (tmp + rename) beside the journal
    segments. Never raises: a refused write (full disk, injected fault)
    degrades the snapshot cadence, not serving. Returns accounting
    {path, bytes, ms} or None."""
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    try:
        raw = wire.dumps(snap)
    except (ValueError, TypeError):
        return None
    data = _HEADER + _FRAME.pack(len(raw), zlib.crc32(raw)) + raw
    path = snapshot_path(directory, snap.version)
    tmp = path + ".tmp"
    try:
        if disk is not None:
            data = disk.apply("snapshot", data)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        prefix = getattr(e, "prefix", None)
        if prefix:
            # a torn snapshot write leaves the PREFIX at the final path —
            # the nastiest crash shape — which read_snapshot must reject
            # by crc and recovery must survive by falling back
            try:
                with open(path, "wb") as f:
                    f.write(prefix)
            except OSError:
                pass
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return {"path": path, "bytes": len(data),
            "ms": (time.perf_counter() - t0) * 1e3}


def read_snapshot(path: str) -> Optional[EngineSnapshot]:
    """One snapshot file; None for any torn/rotted/alien content (the
    journal reader's crc tolerance, applied to the snapshot frame)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < len(_HEADER) + _FRAME.size or \
            data[:len(_HEADER)] != _HEADER:
        return None
    length, crc = _FRAME.unpack_from(data, len(_HEADER))
    raw = data[len(_HEADER) + _FRAME.size:
               len(_HEADER) + _FRAME.size + length]
    if len(raw) != length or zlib.crc32(raw) != crc:
        return None
    try:
        snap = wire.loads(raw)
    except (ValueError, KeyError, TypeError):
        return None
    return snap if isinstance(snap, EngineSnapshot) else None


def latest_snapshot(directory: str) -> Optional[EngineSnapshot]:
    """The newest READABLE snapshot — a torn tail (crash mid-snapshot)
    falls back to the previous one instead of failing recovery."""
    for _v, path in reversed(snapshot_paths(directory)):
        snap = read_snapshot(path)
        if snap is not None:
            return snap
    return None


class SnapshotManager:
    """Cadenced snapshot writer a serving loop notifies per batch."""

    def __init__(self, directory: str, interval: Optional[int] = None,
                 keep: int = 2, disk: Optional[Any] = None,
                 proc: str = ""):
        from ..core.knobs import SERVER_KNOBS

        self.directory = str(directory)
        self.interval = int(
            interval if interval is not None
            else SERVER_KNOBS.resolver_recovery_snapshot_interval)
        self.keep = max(1, int(keep))
        self.disk = disk
        self.proc = proc
        self._last_version = 0
        self.stats = {"written": 0, "bytes": 0, "errors": 0, "ms": 0.0}

    def note_batch(self, engine, version: int) -> Optional[dict]:
        """Called once per resolved batch; snapshots when the cadence is
        due. Never raises into the serving path."""
        if self.interval <= 0:
            return None
        if int(version) - self._last_version < self.interval:
            return None
        return self.snapshot(engine)

    def snapshot(self, engine) -> Optional[dict]:
        try:
            snap = capture(engine, proc=self.proc)
        except Exception:
            self.stats["errors"] += 1
            return None
        acct = write_snapshot(self.directory, snap, disk=self.disk)
        self._last_version = snap.version
        if acct is None:
            self.stats["errors"] += 1
            return None
        self.stats["written"] += 1
        self.stats["bytes"] += acct["bytes"]
        self.stats["ms"] += acct["ms"]
        blackbox.record_snapshot(snap.version, snap.oldest,
                                 len(snap.entries), acct["bytes"],
                                 acct["ms"], path=acct["path"])
        self._prune()
        return acct

    def _prune(self) -> None:
        paths = snapshot_paths(self.directory)
        while len(paths) > self.keep:
            _v, path = paths.pop(0)
            try:
                os.remove(path)
            except OSError:
                break


# -- recovery ------------------------------------------------------------------

@dataclass
class RecoveryResult:
    """What a restart recovered, honestly typed (`cli recovery` renders
    the journaled copy of exactly these fields)."""

    mode: str = MODE_COLD
    coverage_ok: bool = True
    snapshot_version: int = -1
    recovered_version: int = -1
    oldest: int = 0
    snapshot_entries: int = 0
    replayed_batches: int = 0
    verdict_mismatches: int = 0
    blackout_ms: float = 0.0
    warm_ms: float = 0.0
    progcache_hits: int = 0
    progcache_misses: int = 0
    error: Optional[str] = None
    mismatch_detail: List[dict] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "mode": self.mode, "coverage_ok": self.coverage_ok,
            "snapshot_version": self.snapshot_version,
            "recovered_version": self.recovered_version,
            "oldest": self.oldest,
            "snapshot_entries": self.snapshot_entries,
            "replayed_batches": self.replayed_batches,
            "verdict_mismatches": self.verdict_mismatches,
            "blackout_ms": round(self.blackout_ms, 3),
            "warm_ms": round(self.warm_ms, 3),
            "progcache_hits": self.progcache_hits,
            "progcache_misses": self.progcache_misses,
            "error": self.error,
        }


async def _resolve(engine, transactions, now_v, new_oldest):
    r = engine.resolve(transactions, now_v, new_oldest)
    if hasattr(r, "__await__"):
        r = await r
    return r


async def recover(engine, directory: str,
                  journal_events: Optional[List] = None,
                  warm: bool = True,
                  tracker: Optional["RecoveryTracker"] = None,
                  proc: str = "") -> RecoveryResult:
    """Reconstruct `engine`'s interval-table state from the durable
    directory: newest readable snapshot, then differential replay of the
    journal's batch suffix at original versions. Works on supervised
    (async resolve) and raw (sync resolve) engines. Records the arc into
    the installed journal and as a `recovery.blackout` span."""
    t0 = time.perf_counter()
    wall0 = span_now()
    if tracker is not None:
        tracker.begin()
    res = RecoveryResult()
    try:
        snap = latest_snapshot(directory)
        events = (journal_events if journal_events is not None
                  else blackbox.read_journal(directory))
        batches = [e for e in events if e.kind == "batch"]
        complete = bool(events) and min(e.seq for e in events) == 0

        engine.clear(0)
        snap_v = -1
        if snap is not None:
            snap_v = int(snap.version)
            res.snapshot_version = snap_v
            res.snapshot_entries = len(snap.entries)
            res.oldest = int(snap.oldest)
            if snap.oldest > 0:
                # pin the too-old gate FIRST (the _replay_shadow order):
                # replayed reads must face the same horizon they did live
                await _resolve(engine, [], snap.oldest, snap.oldest)
            await handoff.replay_slice(engine, list(snap.entries))

        suffix = [e for e in batches if int(e.payload.version) > snap_v]
        # rotation ate the horizon when the retained journal neither
        # reaches back to its own birth (seq 0) nor overlaps the
        # snapshot version (the diff_replay convention) — a typed
        # degraded mode, never silently-wrong history
        gap = (not complete and bool(batches)
               and (snap is None
                    or int(batches[0].payload.version) > snap_v))
        if gap and suffix:
            floor_v = int(suffix[0].payload.version)
            res.mode = MODE_FROM_FLOOR
            res.coverage_ok = False
            res.oldest = max(res.oldest, floor_v)
            # recover-from-MVCC-floor: everything below the first
            # retained version answers transaction_too_old rather than
            # resolving against unprovable history
            await _resolve(engine, [], floor_v, floor_v)
        elif snap is not None or suffix:
            res.mode = MODE_COMPLETE
        for e in suffix:
            p = e.payload
            got = [int(x) for x in await _resolve(
                engine, list(p.txns), int(p.version), int(p.new_oldest))]
            want = [int(x) for x in p.verdicts]
            res.replayed_batches += 1
            res.recovered_version = int(p.version)
            if got != want:
                res.verdict_mismatches += 1
                if len(res.mismatch_detail) < 8:
                    res.mismatch_detail.append(
                        {"version": int(p.version), "got": got,
                         "want": want})
        if res.recovered_version < 0:
            res.recovered_version = snap_v if snap_v >= 0 else 0
        if warm:
            cache = progcache.active()
            h0 = (cache.stats["hits"], cache.stats["misses"]) \
                if cache is not None else (0, 0)
            tw = time.perf_counter()
            fn = getattr(engine, "ensure_warm", None)
            if fn is not None:
                fn(used_only=True)
            else:
                fn = getattr(engine, "warmup", None)
                if fn is not None:
                    fn()
            res.warm_ms = (time.perf_counter() - tw) * 1e3
            if cache is not None:
                res.progcache_hits = cache.stats["hits"] - h0[0]
                res.progcache_misses = cache.stats["misses"] - h0[1]
    except Exception as e:                     # noqa: BLE001 — recovery
        # must fail TYPED (the caller decides cold-start vs. abort),
        # never half-recovered with the error swallowed
        res.error = f"{type(e).__name__}: {e}"
        res.coverage_ok = False
    res.blackout_ms = (time.perf_counter() - t0) * 1e3
    if tracker is not None:
        tracker.end(res)
    span_event("recovery.blackout", None, wall0, span_now(),
               mode=res.mode, snapshot_version=res.snapshot_version,
               replayed=res.replayed_batches,
               blackout_ms=round(res.blackout_ms, 3), proc=proc or None)
    blackbox.record_recovery(res.as_dict())
    return res


# -- the watchdog's eyes -------------------------------------------------------

class RecoveryTracker:
    """Registered with the telemetry hub (`recovery.<label>.*` series):
    an in-flight recovery's age feeds the watchdog's `recovery_stalled`
    rule, completed arcs feed blackout gauges, and the live tracker
    composes the rule's speakable detail line."""

    def __init__(self, name: str = "recovery", now_fn=span_now):
        self.now_fn = now_fn
        self._started: Optional[float] = None
        self.recoveries = 0
        self.failures = 0
        self.blackout_ms_max = 0.0
        self.last: Optional[dict] = None
        self.label = telemetry.hub().register_recovery(self, name)

    def begin(self) -> None:
        self._started = float(self.now_fn())

    def end(self, res: RecoveryResult) -> None:
        self._started = None
        self.recoveries += 1
        if res.error is not None:
            self.failures += 1
        self.blackout_ms_max = max(self.blackout_ms_max, res.blackout_ms)
        self.last = res.as_dict()

    def in_flight(self) -> bool:
        return self._started is not None

    def in_flight_age_s(self) -> float:
        if self._started is None:
            return 0.0
        return max(0.0, float(self.now_fn()) - self._started)

    def in_flight_detail(self) -> str:
        if self._started is None:
            return ""
        return f"recovery in flight for {self.in_flight_age_s():.2f}s"
